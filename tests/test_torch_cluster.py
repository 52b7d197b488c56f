"""The port's ``serve_real_cluster`` against the reference's: two paged
engines on one runner, the Gimbal control plane over them, a float32 twin of
the test model, the same requests. Finish order, token streams, Algorithm-1
decisions, migrations, expert moves, per-engine counts, fault telemetry and
every other cluster signal must be identical, under the default
configuration, uncalibrated placement (experts migrate), predictive
placement with prefetch, a crash and recovery, a drain, int8 KV pages, and
control-plane snapshots written by one package and restored by the other."""
import dataclasses
import json
import math
import zlib

import jax
import numpy as np
import pytest

import repro.ft.checkpoint as jckpt
from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.core import PlacementConfig as JPlacement
from repro.core import StreamingMetrics as JMetrics
from repro.ft import FaultEvent as JEvent
from repro.ft import FaultPlan as JPlan
from repro.ft.health import HealthConfig as JHealth
from repro.models import build_model
from repro.serving import PagedEngineConfig as JConfig
from repro.serving import PagedModelRunner as JRunner
from repro.serving import PagedRealEngine as JEngine
from repro.serving import RealClusterConfig as JCluster
from repro.serving import Request as JRequest
from repro.serving import serve_real_cluster as j_serve
from repro_torch import ft as tft
from repro_torch.bridge import config_from_dict, params_from_numpy
from repro_torch.core import PlacementConfig as TPlacement
from repro_torch.core import StreamingMetrics as TMetrics
from repro_torch.ft import FaultEvent as TEvent
from repro_torch.ft import FaultPlan as TPlan
from repro_torch.ft import HealthConfig as THealth
from repro_torch.serving import PagedEngineConfig as TConfig
from repro_torch.serving import PagedModelRunner as TRunner
from repro_torch.serving import PagedRealEngine as TEngine
from repro_torch.serving import RealClusterConfig as TCluster
from repro_torch.serving import Request as TRequest
from repro_torch.serving import serve_real_cluster as t_serve

RUNNER = dict(page_size=8, n_pages=48, max_blocks_per_req=8, max_batch=4,
              token_budget=16, chunk_buckets=(8, 16))

# one namespace per package, so each case is written once
JAX = dict(cfg_cls=JConfig, runner_cls=JRunner, engine_cls=JEngine,
           cluster_cls=JCluster, req_cls=JRequest, serve=j_serve,
           placement=JPlacement, metrics=JMetrics, plan=JPlan, event=JEvent,
           health=JHealth, ecfg=dict(attn_backend="xla"))
TORCH = dict(cfg_cls=TConfig, runner_cls=TRunner, engine_cls=TEngine,
             cluster_cls=TCluster, req_cls=TRequest, serve=t_serve,
             placement=TPlacement, metrics=TMetrics, plan=TPlan,
             event=TEvent, health=THealth, ecfg=dict(device="cpu"))


@pytest.fixture(scope="module")
def twin():
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tp = params_from_numpy(jp, device="cpu")
    models = {id(JAX): (cfg, jp), id(TORCH): (tcfg, tp)}
    runners = {}

    def runner(pkg, kv_dtype):
        # one runner per package and KV dtype for the module: the
        # reference's jit caches are shared by every case
        key = (id(pkg), kv_dtype)
        if key not in runners:
            mcfg, params = models[id(pkg)]
            ecfg = pkg["cfg_cls"](**RUNNER, kv_dtype=kv_dtype, **pkg["ecfg"])
            runners[key] = pkg["runner_cls"](mcfg, params, ecfg, n_sources=2)
        return runners[key]

    return models, runner


def _requests(pkg, vocab, n=8, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(6, 30))
        out.append(pkg["req_cls"](
            req_id=i, prompt_len=plen,
            max_new_tokens=int(rng.integers(3, 7)), arrival_time=0.1 * i,
            prompt_tokens=rng.integers(0, vocab, plen).tolist()))
    return out


def _cluster_cfg(pkg, case):
    kw = dict(window_tokens=200,
              health_cfg=pkg["health"](trace_timeout_s=0.3))
    if case.get("migrate"):
        kw.update(window_tokens=48,
                  placement_cfg=pkg["placement"].uncalibrated())
    if case.get("predictive"):
        kw.update(predictive=True, prefetch=True)
    ev = pkg["event"]
    if case.get("fault") == "crash":
        kw["fault_plan"] = pkg["plan"](events=(ev("crash", 1, 8),
                                               ev("recover", 1, 16)))
    elif case.get("fault") == "drain":
        kw["fault_plan"] = pkg["plan"](events=(ev("drain", 1, 6),))
    kw.update(case.get("extra", {}))
    return pkg["cluster_cls"](**kw)


def _run(twin, pkg, case, **extra):
    models, runner = twin
    mcfg, params = models[id(pkg)]
    kv_dtype = case.get("kv_dtype", "auto")
    r = runner(pkg, kv_dtype)
    # adopting a placement swaps the runner's params for a migrated tree;
    # every run starts from the initial weights under identity placement
    r.params = params
    engines = [pkg["engine_cls"](i, mcfg, params, r.ecfg, runner=r,
                                 n_sources=2) for i in range(2)]
    reqs = _requests(pkg, mcfg.vocab_size, seed=case.get("seed", 5))
    metrics = pkg["metrics"](seed=0)
    res = pkg["serve"](reqs, engines,
                       cluster_cfg=_cluster_cfg(pkg, dict(case, extra=extra)),
                       metrics=metrics)
    for e in engines:
        e.pool.check_invariants()
    return res, reqs, engines


def _plain(x):
    """Signals as plain Python values (numpy scalars and arrays unwrapped),
    with NaN made comparable."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return _plain(x.tolist())
    if isinstance(x, np.generic):
        return _plain(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _assert_same_run(j, t):
    (jres, jreqs, jeng), (tres, treqs, teng) = j, t
    for je, te in zip(jeng, teng):
        assert [r.req_id for r in te.finished] == \
            [r.req_id for r in je.finished]
    for jr, tr in zip(jreqs, treqs):
        assert tr.full_output_tokens == jr.full_output_tokens, tr.req_id
        assert (tr.engine_id, tr.error, tr.n_recoveries, tr.n_preemptions) \
            == (jr.engine_id, jr.error, jr.n_recoveries, jr.n_preemptions)
        assert (tr.first_token_time, tr.finish_time) == \
            (jr.first_token_time, jr.finish_time)
    assert tres.duration_s == jres.duration_s
    assert _plain(tres.signals) == _plain(jres.signals)


CASES = {
    "default": dict(),
    "migrate": dict(migrate=True),
    "predictive_prefetch": dict(migrate=True, predictive=True),
    "crash_recover": dict(fault="crash"),
    "drain": dict(fault="drain"),
    "int8_pages": dict(kv_dtype="int8", migrate=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cluster_matches_reference(twin, name):
    case = CASES[name]
    j = _run(twin, JAX, case)
    t = _run(twin, TORCH, case)
    _assert_same_run(j, t)
    sig = t[0].signals
    assert sig["unfinished"] == 0 and not sig["errors"]
    assert sum(sig["per_engine"].values()) == 8
    if case.get("migrate"):
        assert sig["migrations"] > 0 and sig["expert_moves"] > 0
    if case.get("predictive"):
        assert sig["prefetch_pointer_swaps"] > 0
    if name == "crash_recover":
        assert sig["n_failures"] == 1 and sig["recovered_requests"] >= 1
        events = [ev["event"] for ev in sig["health_events"]
                  if ev["engine"] == 1]
        assert "down" in events and "rejoin" in events
    if name == "drain":
        assert 1 in sig["drained_engines"]


@pytest.fixture
def zlib_reference(monkeypatch):
    # the reference writes zstd frames where ``zstandard`` is installed and
    # zlib where it is not; the port reads zlib only, so the reference is
    # made to write as an install without zstandard does
    monkeypatch.setattr(jckpt, "_compress", lambda d: zlib.compress(d, 3))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_restores_across_packages(twin, tmp_path, zlib_reference,
                                           writer):
    case = dict(migrate=True)
    path = str(tmp_path / "cluster_state")
    _run(twin, JAX if writer == "jax" else TORCH, case,
         snapshot_every_rounds=5, snapshot_path=path)
    step = tft.checkpoint_step(path)
    assert step is not None and step > 0 and step % 5 == 0
    tree, comp = tft.restore_serving_state(path)
    jtree, jcomp = jckpt.restore_serving_state(path)
    assert comp == jcomp
    for k in jtree:
        np.testing.assert_array_equal(tree[k], np.asarray(jtree[k]))
    assert tft.restore_serving_extra(path) == \
        jckpt.restore_serving_extra(path)
    # a new cluster of each package resumes from the snapshot: same run
    resumed = dict(case, seed=9)
    j = _run(twin, JAX, resumed, restore_from=path)
    t = _run(twin, TORCH, resumed, restore_from=path)
    _assert_same_run(j, t)
    assert t[0].signals["unfinished"] == 0


def test_port_snapshot_is_the_reference_format(tmp_path):
    """Byte-level format: the same state saved by both packages gives the
    same manifest and the same leaf bytes once decompressed."""
    rng = np.random.default_rng(0)
    state = dict(placement_assign=rng.integers(0, 4, (2, 8)),
                 profiler_B=rng.integers(0, 9, (2, 8)),
                 profiler_A=rng.integers(0, 9, (2, 2, 8)),
                 scheduler_comp={0: 0.5, 1: 0.25},
                 traces={0: {"kv_usage": 0.1}}, step=7)
    tft.save_serving_state(str(tmp_path / "t"), **state)
    jckpt.save_serving_state(str(tmp_path / "j"), **state)
    man = [json.loads((tmp_path / d / "manifest.json").read_text())
           for d in ("t", "j")]
    assert man[0] == man[1]
    for i in range(man[0]["n_leaves"]):
        raw = [jckpt._decompress((tmp_path / d / f"leaf_{i:05d}.zst")
                                 .read_bytes()) for d in ("t", "j")]
        assert raw[0] == raw[1]


def test_port_refuses_a_zstd_snapshot(tmp_path):
    path = tmp_path / "zstd_state"
    tft.save_serving_state(str(path), placement_assign=np.zeros((1, 4)),
                           profiler_B=np.zeros((1, 4)),
                           profiler_A=np.zeros((1, 2, 4)),
                           scheduler_comp={})
    # a leaf as an install with zstandard writes it: a zstd frame
    (path / "leaf_00000.zst").write_bytes(b"\x28\xb5\x2f\xfd" + bytes(16))
    with pytest.raises(RuntimeError, match="zstd"):
        tft.restore_serving_state(str(path))
