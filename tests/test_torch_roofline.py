"""The port's cost counting, roofline and perf CLIs.

* ``model_flops_for`` equals the reference's for every arch x shape, and
  ``RooflineTerms.to_dict`` has the reference's keys.
* The collective counter (``launch/collective_analysis.py``) on a fake
  (2, 4) world counts the output bytes of the calls made, and
  ``launch/cost.py`` counts them as collective bytes, not memory traffic.
* Each kernel wrapper counts its own formula (the ``*_cost`` function of
  its module) under ``count_costs``, not its plain version's ops, so a
  cell counts the same work whichever route ran.
* The extrapolation from 1 and 2 super-blocks equals the count at full
  depth exactly on a dense stack (qwen3-8b's smoke widths, 4 super-blocks,
  float32).
* Every arch x shape runs as rank 0 of the fake world at smoke widths,
  its drawn args exactly their spec bytes.
* ``perf_run`` and ``roofline_run`` run on the CPU when asked and fail
  without a card when not.

The fake world is process-global: the module's fixture makes it and
destroys it at the end.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.launch import roofline as jroof
from repro_torch.configs import (SHAPES, ShapeConfig, get_config,
                                 get_shape, get_smoke_config, list_archs,
                                 reduced)
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import kv_pack, moe_gmm, paged_decode
from repro_torch.kernels import source_expert_count as sec
from repro_torch.kernels.moe_dispatch import ragged_dispatch
from repro_torch.launch import cells as tcells
from repro_torch.launch import roofline as troof
from repro_torch.launch.collective_analysis import (COLLECTIVES,
                                                    count_collectives)
from repro_torch.launch.cost import count_costs

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fake_mesh
    m = make_fake_mesh((2, 4), ("data", "model"), "cpu")
    yield m
    dist.destroy_process_group()


# ------------------------------------------------------------ the reference
@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference(arch, shape):
    assert troof.model_flops_for(get_config(arch), get_shape(shape)) \
        == jroof.model_flops_for(j_get_config(arch), j_get_shape(shape))


def test_terms_have_the_reference_keys():
    args = ("a", "s", "m", 2e12, 3e9, 1e8, 256, 1e15)
    mine, theirs = troof.RooflineTerms(*args), jroof.RooflineTerms(*args)
    assert list(mine.to_dict()) == list(theirs.to_dict())
    d = mine.to_dict()
    assert d["compute_s"] == 2e12 / troof.PEAK_FLOPS
    assert d["memory_s"] == 3e9 / troof.HBM_BW
    assert d["collective_s"] == 1e8 / troof.LINK_BW
    assert d["bottleneck"] == "compute"
    assert d["useful_flops_ratio"] == 1e15 / (2e12 * 256)


# ------------------------------------------------------------- collectives
COLL_CASES = [("all-reduce", "model", 0, torch.bfloat16),
              ("all-reduce", ("data", "model"), 0, torch.float32),
              ("all-reduce-max", "data", 0, torch.float32),
              ("all-gather", "model", 0, torch.bfloat16),
              ("all-gather", "data", 1, torch.float32),
              ("all-gather", ("data", "model"), 2, torch.int32)]


@pytest.mark.parametrize("kind,axes,dim,dtype", COLL_CASES,
                         ids=lambda v: str(v))
def test_collectives_count_the_bytes_of_the_calls_made(mesh, kind, axes,
                                                       dim, dtype):
    pol = ShardingPolicy(mesh=mesh, batch_axes=("data",), fsdp_axes=())
    t = torch.arange(60).reshape(3, 4, 5).to(dtype)
    n = pol.size(axes)
    with count_costs() as c, count_collectives() as coll:
        if kind.startswith("all-reduce"):
            out = pol.all_reduce(t, axes, op="max" if "max" in kind
                                 else "sum")
            kind, nbytes = "all-reduce", t.numel() * t.element_size()
        else:
            out = pol.all_gather(t, axes, dim)
            nbytes = n * t.numel() * t.element_size()
            assert out.shape[dim] == n * t.shape[dim]
        # one rank's block in every part: the fake backend's gather
        pol.all_gather(t[:1], "model", 0)
    extra = 4 * t[:1].numel() * t.element_size()
    assert set(coll) == set(COLLECTIVES)
    assert coll[kind] == {"count": 1 + (kind == "all-gather"),
                          "bytes": nbytes + (kind == "all-gather") * extra}
    assert sum(v["count"] for v in coll.values()) == 2
    assert c.collective_bytes == nbytes + extra
    assert c.bytes == 0 and c.flops == 0     # no memory traffic counted


def test_collectives_are_spans_the_profiler_shows(mesh):
    """The ``collective:*`` ranges ``chip_smoke.py`` reads: spans of
    ``counting``, which a profiler session records and shows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import counting
    pol = ShardingPolicy(mesh=mesh, batch_axes=("data",), fsdp_axes=())
    counting.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pol.all_reduce(torch.ones(4), "model")
        pol.all_gather(torch.ones(4), "data", 0)
    host = sorted(e.name for e in prof.events()
                  if e.name.startswith("collective:")
                  and e.device_type == DeviceType.CPU)
    assert host == ["collective:all_gather", "collective:all_reduce"]
    assert [s.name for s in counting.spans()] == ["collective:all_reduce",
                                                  "collective:all_gather"]
    counting.clear_spans()
    pol.all_reduce(torch.ones(4), "model")      # nothing records now
    assert counting.spans() == []


def test_collectives_over_one_rank_record_nothing(mesh):
    from repro_torch.launch.mesh import Mesh
    one = Mesh((1, 8), ("data", "model"))
    pol = ShardingPolicy(mesh=one, batch_axes=(), fsdp_axes=())
    with count_collectives() as coll:
        pol.all_reduce(torch.ones(4), "data")
        pol.all_gather(torch.ones(4), "data", 0)
    assert all(v == {"count": 0, "bytes": 0} for v in coll.values())


# ----------------------------------------------------------------- kernels
def _g():
    return torch.Generator().manual_seed(0)


def _paged(int8):
    B, Hq, Hkv, hd, ps, NB, P = 3, 8, 2, 16, 4, 5, 16
    q = torch.randn(B, Hq, hd, generator=_g())
    kp, vp = (torch.randn(P, ps, Hkv, hd, generator=_g()) for _ in range(2))
    kw = {}
    if int8:
        (kp, ks), (vp, vs) = kv_pack.pack_kv_plain(kp), \
            kv_pack.pack_kv_plain(vp)
        kw = dict(k_scales=ks, v_scales=vs)
    bt = torch.randint(1, P, (B, NB), generator=_g(), dtype=torch.int32)
    ctx = torch.tensor([0, 7, 20], dtype=torch.int32)
    return (lambda: paged_decode.paged_decode(q, kp, vp, bt, ctx, **kw),
            paged_decode.paged_decode_cost(B, Hq, Hkv, hd, NB, 27, 4,
                                           kp.element_size(), int8),
            "paged_decode")


def _flash(lse):
    B, Hq, Hkv, hd, L = 2, 8, 2, 16, 12
    q = torch.randn(B, Hq, hd, generator=_g())
    kc, vc = (torch.randn(B, L, Hkv, hd, generator=_g()) for _ in range(2))
    k_pos = torch.tensor([list(range(L)), [-1] * 4 + list(range(8))],
                         dtype=torch.int32)
    q_pos = torch.tensor([9, 7], dtype=torch.int32)
    n_valid = 10 + 8                       # slots at or before q_pos
    return (lambda: fd.flash_decode(q, kc, vc, k_pos, q_pos,
                                    return_lse=lse),
            fd.flash_decode_cost(B, Hq, Hkv, hd, L, n_valid, 4, 4,
                                 return_lse=lse), "flash_decode")


def _ragged():
    T, K, E, D, F = 10, 2, 4, 16, 24
    ids = torch.randint(0, E, (T, K), generator=_g(), dtype=torch.int32)
    disp = ragged_dispatch(torch.randn(T, D, generator=_g()), ids, E,
                           row_block=8)
    w = torch.randn(E, D, F, generator=_g())
    gs = disp.group_sizes
    return (lambda: moe_gmm.moe_gmm_ragged(
        disp.xs, w, disp.tile_expert, gs, disp.padded_offsets, n_block=8),
            moe_gmm.moe_gmm_ragged_cost(
                T * K, int((gs > 0).sum()), disp.xs.shape[0], D, F, E,
                disp.tile_expert.numel(), 4), "moe_gmm_ragged")


def _padded():
    x = torch.randn(3, 5, 16, generator=_g())
    w = torch.randn(3, 16, 8, generator=_g())
    return (lambda: moe_gmm.moe_gmm(x, w),
            moe_gmm.moe_gmm_cost(3, 5, 16, 8, 4), "moe_gmm")


def _stats():
    ids = torch.randint(-1, 6, (7, 3), generator=_g(), dtype=torch.int32)
    src = torch.randint(0, 2, (7,), generator=_g(), dtype=torch.int32)
    return (lambda: sec.source_expert_count(ids, src, n_experts=6,
                                            n_sources=2),
            sec.source_expert_count_cost(7, 3, 6, 2), "source_expert_count")


def _pack():
    t = torch.randn(5, 2, 16, generator=_g()).to(torch.bfloat16)
    return (lambda: kv_pack.pack_kv(t), kv_pack.pack_kv_cost(10, 16, 2),
            "pack_kv")


def _pages():
    B, S, Hkv, hd, ps, P = 2, 3, 2, 16, 4, 6
    k, v = (torch.randn(B, S, Hkv, hd, generator=_g()) for _ in range(2))
    pools = [torch.zeros(P, ps, Hkv, hd, dtype=torch.int8) for _ in range(2)]
    scales = [torch.zeros(P, ps, Hkv) for _ in range(2)]
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([[0, 1, 2], [4, 5, 6]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False], [True, True, True]])
    return (lambda: kv_pack.pack_kv_into_pages(k, v, *pools, *scales, bt,
                                               pos, valid),
            kv_pack.pack_kv_write_cost(12, 10, hd, 4, 4 * (4 + 6) + 6),
            "pack_kv")


def _ring():
    B, S, Hkv, hd, L = 2, 3, 2, 16, 4
    k, v = (torch.randn(B, S, Hkv, hd, generator=_g()) for _ in range(2))
    caches = [torch.zeros(B, L, Hkv, hd, dtype=torch.int8) for _ in range(2)]
    scales = [torch.zeros(B, L, Hkv) for _ in range(2)]
    pos = torch.tensor([[5, 6, 7], [9, 10, 11]], dtype=torch.int32)
    # a rank's slots [4, 8) of a 12-slot ring: row 0's positions land at
    # local slots 1, 2, 3, row 1's at 5, 6, 7, past the rank's four
    return (lambda: kv_pack.pack_kv_into_ring(k, v, *caches, *scales, pos,
                                              ring_len=12, slot0=4),
            kv_pack.pack_kv_write_cost(12, 3 * Hkv, hd, 4, 4 * 6),
            "pack_kv")


def _unpack():
    q = torch.randint(-127, 128, (4, 3, 16), generator=_g(),
                      dtype=torch.int8)
    s = torch.rand(4, 3, generator=_g())
    return (lambda: kv_pack.unpack_kv(q, s, torch.bfloat16),
            kv_pack.unpack_kv_cost(192, 12, 2), "unpack_kv")


KERNELS = {"paged_decode": lambda: _paged(False),
           "paged_decode_int8": lambda: _paged(True),
           "flash_decode": lambda: _flash(False),
           "flash_decode_split_k_shard": lambda: _flash(True),
           "moe_gmm_ragged": _ragged, "moe_gmm": _padded,
           "source_expert_count": _stats, "pack_kv": _pack,
           "pack_kv_into_pages": _pages, "pack_kv_into_ring": _ring,
           "unpack_kv": _unpack}


@pytest.mark.parametrize("case", list(KERNELS))
def test_a_kernel_counts_its_formula_not_its_plain_ops(case):
    run, (flops, nbytes), name = KERNELS[case]()
    with count_costs() as c:
        run()
    assert c.kernels == {name: {"count": 1, "flops": flops,
                                "bytes": nbytes}}
    assert (c.flops, c.bytes, c.ops) == (flops, nbytes, 0)


def test_the_padded_gemm_counts_its_backward_products():
    x = torch.randn(3, 5, 16, generator=_g(), requires_grad=True)
    w = torch.randn(3, 16, 8, generator=_g(), requires_grad=True)
    with count_costs() as c:
        moe_gmm.moe_gmm(x, w).sum().backward()
    assert c.kernels["moe_gmm"]["count"] == 3
    assert c.kernels["moe_gmm"]["flops"] == 3 * 2 * 3 * 5 * 16 * 8


# ------------------------------------------------------------------- depth
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_depth_extrapolation_is_exact_on_a_dense_stack(mesh, kind):
    cfg = reduced(get_smoke_config("qwen3-8b"), n_layers=4, dtype="float32")
    cell = tcells.build_cell(cfg, ShapeConfig(kind, 32, 8, kind), mesh)
    full, tot_full = troof.depth_counts(cell, mesh, device="cpu",
                                        n_super=None)
    runs, tot = troof.depth_counts(cell, mesh, device="cpu")
    assert [r.n_super for r in runs] == [1, 2] and full[0].n_super is None
    assert tot == tot_full
    assert all(v > 0 for v in tot.values())


# ------------------------------------------------------------------- cells
@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", list_archs())
def test_every_cell_runs_as_rank_0_at_smoke_widths(mesh, arch, shape):
    cfg, shp = tcells.resolve(arch, shape, smoke=True)
    cell = tcells.build_cell(cfg, shp, mesh)
    if cell.skip_reason:
        assert shape == "long_500k"
        return
    live = tcells.materialize_cell(cell, mesh, generator=_g(),
                                   device="cpu")
    assert tcells.resident_bytes(live.args) == tcells.argument_bytes(cell)
    c = troof.count_live(live)
    assert c.flops > 0 and c.bytes > 0 and c.collective_bytes > 0


# -------------------------------------------------------------------- CLIs
def run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


CLIS = {"perf_run": ("--cell", "qwen3-moe-30b-a3b:decode_32k", "--smoke"),
        "roofline_run": ("--arch", "qwen3-8b", "--smoke")}


@pytest.mark.parametrize("cli", list(CLIS))
def test_cli_on_the_cpu_when_asked(tmp_path, cli):
    res = run(f"repro_torch.launch.{cli}", *CLIS[cli], "--device", "cpu",
              "--outdir", str(tmp_path))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*"))]
    if cli == "perf_run":
        assert [r["variant"] for r in recs] == ["v0-v3_padded",
                                                "v4_ragged_dispatch"]
        assert all(r["step_ms"] is None and r["device"] == "cpu"
                   for r in recs)
        assert "step not measured" in res.stdout
    else:
        assert len(recs) == len(SHAPES)
        assert sum(r["skip"] is not None for r in recs) == 1
    keys = list(jroof.RooflineTerms("", "", "", 1, 1, 1, 1, 1).to_dict())
    for r in recs:
        assert list(r)[:len(keys)] == keys
        if r["skip"] is None:
            assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0


@pytest.mark.parametrize("cli", list(CLIS))
def test_cli_without_a_card_fails(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    res = run(f"repro_torch.launch.{cli}", *CLIS[cli], "--outdir",
              str(tmp_path))
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not list(tmp_path.glob("*.json"))
