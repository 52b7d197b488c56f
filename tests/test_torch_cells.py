"""The port's launch cells against the reference's, and the dry-run CLI.

Cells: a subprocess with 512 host devices runs the reference's
``launch/cells.py::build_cell`` for every arch x the four shapes x the
debug (2, 4), single-pod (16, 16) and multi-pod (2, 16, 16) meshes and
writes each arg leaf's path, global shape, dtype, ``NamedSharding.spec``
and shard bytes (``shard_shape``), and each skip reason. The port's cells
(``repro_torch.launch.cells``, meta trees and spec trees, no devices) must
equal them leaf for leaf, and their per-rank argument bytes exactly.

The CLI: the abstract ``dryrun --all --debug-mesh`` exits 0; ``--execute
--device cpu`` runs a cell's rank 0 on the CPU at smoke widths as rank 0 of
a fake world; ``--execute`` without a card and without ``--device cpu``
fails; ``make_fake_mesh`` without the fake backend raises.

Run as a script (``python tests/test_torch_cells.py OUT``) this file
writes the reference's cells to ``OUT``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch import cells as tcells
from repro_torch.launch import mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = {
    "debug": tmesh.make_debug_mesh(),
    "pod16x16": tmesh.make_production_mesh(),
    "pod2x16x16": tmesh.make_production_mesh(multi_pod=True),
}


def _spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def dump_reference(out: str) -> None:
    """The reference's cells on 512 host devices (set before jax loads)."""
    import jax
    import numpy as np
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import list_archs as j_list_archs
    from repro.launch.cells import build_cell
    from repro.launch.mesh import make_debug_mesh, make_production_mesh

    def key(k):
        if hasattr(k, "key"):
            return str(k.key)
        if hasattr(k, "idx"):
            return f"[{k.idx}]"
        return getattr(k, "name", str(k))

    is_ns = lambda x: isinstance(x, jax.sharding.NamedSharding)  # noqa: E731
    meshes = {"debug": make_debug_mesh(), "pod16x16": make_production_mesh(),
              "pod2x16x16": make_production_mesh(multi_pod=True)}
    res = {}
    for mname, mesh in meshes.items():
        for arch in j_list_archs():
            for s in J_SHAPES:
                cell = build_cell(arch, s.name, mesh)
                rec = {"skip": cell.skip_reason, "leaves": []}
                if not cell.skip_reason:
                    leaves = jax.tree_util.tree_flatten_with_path(
                        cell.args)[0]
                    shs = jax.tree_util.tree_leaves(cell.in_shardings,
                                                    is_leaf=is_ns)
                    assert len(leaves) == len(shs)
                    for (path, leaf), sh in zip(leaves, shs):
                        nbytes = int(np.prod(sh.shard_shape(leaf.shape))) \
                            * leaf.dtype.itemsize
                        rec["leaves"].append(
                            ["/".join(key(k) for k in path),
                             list(leaf.shape), str(leaf.dtype),
                             _spec(sh.spec), nbytes])
                res[f"{arch}|{s.name}|{mname}"] = rec
    with open(out, "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", list_archs())
def test_cell_equals_the_reference(reference, arch, shape, mesh_name):
    ref = reference[f"{arch}|{shape}|{mesh_name}"]
    cell = tcells.build_cell(arch, shape, MESHES[mesh_name])
    assert cell.skip_reason == ref["skip"]
    if cell.skip_reason:
        return
    tcells.check_specs(cell)
    mine = {p: [list(sh), str(dt).replace("torch.", ""), _spec(sp), b]
            for p, sh, dt, sp, b in tcells.cell_leaves(cell)}
    theirs = {r[0]: r[1:] for r in ref["leaves"]}
    assert sorted(mine) == sorted(theirs)
    for path in theirs:
        assert mine[path] == theirs[path], path
    assert tcells.argument_bytes(cell) == sum(r[-1] for r in ref["leaves"])


def run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


def test_abstract_dryrun_of_every_cell_exits_0(tmp_path):
    res = run("repro_torch.launch.dryrun", "--all", "--debug-mesh",
              "--outdir", str(tmp_path))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "all cells OK" in res.stdout
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == len(list_archs()) * len(SHAPES)
    ok = [r for r in recs if r["status"] == "OK"]
    assert ok and all(r["memory"]["argument_bytes"] > 0 and r["fits_card"]
                      is (r["memory"]["argument_bytes"] <= 80 * 2 ** 30)
                      for r in ok)
    assert {r["status"] for r in recs} == {"OK", "SKIP"}


def test_executed_dryrun_on_the_cpu_when_asked(tmp_path):
    res = run("repro_torch.launch.dryrun", "--arch", "qwen3-moe-30b-a3b",
              "--shape", "decode_32k", "--debug-mesh", "--smoke",
              "--execute", "--device", "cpu", "--outdir", str(tmp_path))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rec = json.loads((tmp_path / "qwen3-moe-30b-a3b__decode_32k__"
                      "debug_pod16x16.json").read_text())
    mem = rec["memory"]
    assert rec["status"] == "OK" and rec["device"] == "cpu"
    assert mem["resident_arg_bytes"] == mem["argument_bytes"] > 0
    assert mem["temp_bytes"] is None            # not measured on the CPU
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["collective_bytes"] == sum(
        v["bytes"] for v in rec["collectives"].values())
    assert {"flash_decode", "source_expert_count"} <= set(rec["kernels"])
    assert not any(rec["launches"].values())    # plain versions, no launch


def test_executed_dryrun_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    res = run("repro_torch.launch.dryrun", "--arch", "qwen3-8b", "--shape",
              "decode_32k", "--execute", "--outdir", str(tmp_path))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not list(tmp_path.glob("*.json"))


def test_fake_mesh_without_the_backend_raises(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake process group"):
        tmesh.make_fake_mesh((2, 4), ("data", "model"), "cpu")
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    dump_reference(sys.argv[1])
