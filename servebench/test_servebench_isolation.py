"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference, the weights and each architecture's reference side load nothing
of the program.

Each check runs in a fresh interpreter: the test process itself may hold
JAX from other test files. Top-level module names are compared whole (the
port's name begins with the JAX package's)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _modules_after(code: str) -> set:
    prog = ("import sys, json\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            + code +
            "\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    code = """
import torch
torch.set_num_threads(1)
from servebench import harness, run
cell = harness.load_cell("qwen3moe_burst_prefill", size="smoke")
r, checks, desc = run.measure(cell, 3, 1e9, False, "cpu", rounds=20)
run.result(r, checks, desc, False)
import importlib.util, pathlib
for p in sorted(pathlib.Path("servebench").glob("*.py")):
    if not p.name.startswith("test_"):
        __import__("servebench." + p.stem)
for p in sorted(pathlib.Path("servebench/arch").glob("[!_]*.py")):
    __import__("servebench.arch." + p.stem)
"""
    mods = _modules_after(code)
    assert "repro_torch" in mods and "servebench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after("from servebench import reference, weights")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


REFERENCE_SIDE = ["servebench.weights"] + [
    f"servebench.arch.{p.stem}"
    for p in sorted((ROOT / "servebench" / "arch").glob("*_ref.py"))]


@pytest.mark.parametrize("module", REFERENCE_SIDE)
def test_each_reference_side_loads_nothing_of_the_program(module):
    """``weights.py`` and every adapter's reference side, each alone."""
    mods = _modules_after(f"import {module}")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
