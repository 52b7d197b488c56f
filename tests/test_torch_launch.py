"""The port's serving CLIs and real-plane examples. In simulated mode the
port's ``launch.serve`` prints the reference's JSON, and ``launch.stress
--list`` its listing; with ``--real`` it serves the tiny model through the
port's examples on the CPU when asked to, and fails without a card when it
is not. The paged example's ``--shared-prefix`` and ``--chaos`` modes hold
their own bit-identity asserts on the float32 twin of the smoke model."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config, reduced
from repro_torch.examples import serve_moe_paged

SRC = Path(__file__).resolve().parents[1] / "src"


def run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=SRC.parent)


@pytest.mark.parametrize("args", [
    ("--system", "gimbal", "--dist", "random", "--requests", "100"),
    ("--system", "vllm", "--sessions", "--requests", "150", "--rps", "6"),
    ("--scenario", "zipf_burst_central", "--requests", "300"),
], ids=["gimbal_random", "vllm_sessions", "scenario"])
def test_simulated_serve_prints_the_reference_json(args):
    j = run("repro.launch.serve", *args)
    t = run("repro_torch.launch.serve", *args)
    assert j.returncode == 0, j.stderr
    assert t.returncode == 0, t.stderr
    if args[0] == "--scenario":
        # the dashboard's wall-clock entries differ between any two runs
        strip = lambda out: [ln for ln in out.splitlines()  # noqa: E731
                             if not any(k in ln for k in (
                                 '"wall_s"', '"build_s"',
                                 '"requests_per_wall_s"'))]
        assert strip(t.stdout) == strip(j.stdout)
    else:
        assert t.stdout == j.stdout
    assert '"signals"' in t.stdout or '"invariants_ok": true' in t.stdout


def test_stress_list_is_the_reference_listing():
    j = run("repro.launch.stress", "--list")
    t = run("repro_torch.launch.stress", "--list")
    assert j.returncode == t.returncode == 0
    assert t.stdout == j.stdout and len(t.stdout.splitlines()) == 6


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_real_serve_on_the_cpu_when_asked(paged):
    t = run("repro_torch.launch.serve", "--real",
            *(("--paged",) if paged else ()), "--device", "cpu")
    assert t.returncode == 0, t.stdout + t.stderr
    assert "served 12/12" in t.stdout


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_real_serve_without_a_card_fails(paged):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    t = run("repro_torch.launch.serve", "--real",
            *(("--paged",) if paged else ()))
    assert t.returncode != 0
    assert "served" not in t.stdout


@pytest.mark.parametrize("mode", ["shared_prefix", "chaos"])
def test_example_modes_hold_their_asserts_on_the_float32_twin(mode, capsys):
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), dtype="float32")
    serve_moe_paged.main(**{mode: True}, device="cpu", cfg=cfg)
    out = capsys.readouterr().out
    assert out.count("served 12/12") == (2 if mode == "shared_prefix" else 1)
    assert ("bit-identical outputs: True" in out if mode == "shared_prefix"
            else "bit-exact vs fault-free: True" in out)



def test_placement_demo_prints_the_reference_output():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    j = subprocess.run([sys.executable, "examples/placement_demo.py"],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=SRC.parent)
    t = run("repro_torch.examples.placement_demo")
    assert j.returncode == 0, j.stderr
    assert t.returncode == 0, t.stderr
    assert t.stdout == j.stdout
    assert "MINLP reference" in t.stdout and "calibration:" in t.stdout


def test_train_cli_checkpoints_and_resumes_on_the_cpu(tmp_path):
    """``launch.train --device cpu`` checkpoints every 2 steps; a run with
    ``--resume`` continues from the saved step, on the batches an
    uninterrupted run would see, to the same loss."""
    common = ("--device", "cpu", "--batch", "2", "--seq", "16")
    ck = ("--checkpoint", str(tmp_path / "ck"), "--checkpoint-every", "2")
    first = run("repro_torch.launch.train", "--steps", "4", *common, *ck)
    assert first.returncode == 0, first.stdout + first.stderr
    assert "checkpointed at step 4" in first.stdout
    resumed = run("repro_torch.launch.train", "--steps", "6", "--resume",
                  *common, *ck)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert "resumed from step 4" in resumed.stdout
    assert "checkpointed at step 6" in resumed.stdout
    straight = run("repro_torch.launch.train", "--steps", "6", *common)
    assert straight.returncode == 0, straight.stdout + straight.stderr

    def last_loss(out):
        return [ln.split()[2] for ln in out.splitlines()
                if ln.startswith("step    5")]

    assert last_loss(resumed.stdout) == last_loss(straight.stdout) != []


@pytest.mark.parametrize("module,expect", [
    ("repro_torch.examples.quickstart", "generated token ids"),
    ("repro_torch.examples.fault_tolerance_demo",
     "bit-exact continuation: True")], ids=["quickstart", "fault_tolerance"])
def test_training_examples_on_the_cpu_when_asked(module, expect):
    t = run(module, "--device", "cpu")
    assert t.returncode == 0, t.stdout + t.stderr
    assert expect in t.stdout


@pytest.mark.parametrize("module", [
    "repro_torch.launch.train", "repro_torch.examples.quickstart",
    "repro_torch.examples.fault_tolerance_demo"],
    ids=["train", "quickstart", "fault_tolerance"])
def test_training_drivers_without_a_card_fail(module):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    t = run(module)
    assert t.returncode != 0
