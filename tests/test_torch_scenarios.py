"""The scenario slices on the port's real plane, against the reference. A
float32 twin of the test model (2 layers) serves the same real slice of a
registered scenario through both packages' ``serve_real_cluster`` on
prefix-sharing paged engines: the token streams, the invariant pack's
aggregates and the Algorithm-1 decision counts must be equal. And the
reference's sim<->real gate on the port's two planes: the same session slice
served by the port's real cluster and by its ``simulate`` finishes the same
requests, with the same prefix-hit tokens and affinity decisions."""
import dataclasses

import jax
import pytest

from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.core import SchedulerConfig as JSchedulerConfig
from repro.core import StreamingMetrics as JMetrics
from repro.models import build_model
from repro.serving import PagedEngineConfig as JConfig
from repro.serving import PagedModelRunner as JRunner
from repro.serving import PagedRealEngine as JEngine
from repro.serving import RealClusterConfig as JCluster
from repro.serving import serve_real_cluster as j_serve
from repro.workloads import scenarios as jscen
from repro_torch.bridge import config_from_dict, params_from_numpy
from repro_torch.core import SchedulerConfig as TSchedulerConfig
from repro_torch.core import StreamingMetrics as TMetrics
from repro_torch.serving import EngineConfig, SystemConfig, simulate
from repro_torch.serving import PagedEngineConfig as TConfig
from repro_torch.serving import PagedModelRunner as TRunner
from repro_torch.serving import PagedRealEngine as TEngine
from repro_torch.serving import RealClusterConfig as TCluster
from repro_torch.serving import serve_real_cluster as t_serve
from repro_torch.workloads import scenarios as tscen

from test_torch_simulator import plain

RUNNER = dict(page_size=8, n_pages=96, max_blocks_per_req=8, max_batch=4,
              token_budget=16, chunk_buckets=(8, 16), prefix_sharing=True)

JAX = dict(cfg_cls=JConfig, runner_cls=JRunner, engine_cls=JEngine,
           cluster_cls=JCluster, serve=j_serve, metrics=JMetrics,
           sched=JSchedulerConfig, scen=jscen, ecfg=dict(attn_backend="xla"))
TORCH = dict(cfg_cls=TConfig, runner_cls=TRunner, engine_cls=TEngine,
             cluster_cls=TCluster, serve=t_serve, metrics=TMetrics,
             sched=TSchedulerConfig, scen=tscen, ecfg=dict(device="cpu"))


@pytest.fixture(scope="module")
def twin():
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    models = {id(JAX): (cfg, jp),
              id(TORCH): (config_from_dict(dataclasses.asdict(cfg)),
                          params_from_numpy(jp, device="cpu"))}
    runners = {}

    def runner(pkg):
        mcfg, params = models[id(pkg)]
        if id(pkg) not in runners:
            ecfg = pkg["cfg_cls"](**RUNNER, **pkg["ecfg"])
            runners[id(pkg)] = pkg["runner_cls"](mcfg, params, ecfg,
                                                 n_sources=2)
        # adopting a placement swaps the runner's params for a migrated
        # tree: every serve starts from the initial weights
        runners[id(pkg)].params = params
        return mcfg, runners[id(pkg)]

    return runner


def real_slice(pkg, cfg, ecfg, name, n, sequential=False, **kw):
    max_prompt = ecfg.max_blocks_per_req * ecfg.page_size - 16
    reqs = pkg["scen"].build_real_slice(
        pkg["scen"].SCENARIOS[name], n, seed=13, vocab=cfg.vocab_size,
        max_prompt=max_prompt, **kw)
    if sequential:
        # every turn arrives long after the previous one finished, so cache
        # decisions depend only on tokens, not on either plane's timing
        for i, r in enumerate(reqs):
            r.arrival_time = 3.0 * (i + 1)
    return reqs


def serve_slice(twin, pkg, name, n, sequential=False, **kw):
    cfg, runner = twin(pkg)
    engines = [pkg["engine_cls"](i, cfg, runner.params, runner.ecfg,
                                 runner=runner, n_sources=2)
               for i in range(2)]
    reqs = real_slice(pkg, cfg, runner.ecfg, name, n, sequential, **kw)
    metrics = pkg["metrics"](window_s=5.0, seed=0)
    res = pkg["serve"](reqs, engines, metrics=metrics,
                       cluster_cfg=pkg["cluster_cls"](
                           window_tokens=200,
                           scheduler_cfg=pkg["sched"]()))
    inv = pkg["scen"].check_scenario_invariants(reqs, res, engines=engines,
                                                metrics=metrics)
    return reqs, res, inv


@pytest.mark.slow
@pytest.mark.parametrize("name", ["agentic_sessions", "chat_oneshot"])
def test_scenario_slice_matches_reference(twin, name):
    jreqs, jres, jinv = serve_slice(twin, JAX, name, 16, rps=3.0)
    treqs, tres, tinv = serve_slice(twin, TORCH, name, 16, rps=3.0)
    assert [r.full_output_tokens for r in treqs] == \
        [r.full_output_tokens for r in jreqs]
    assert [(r.engine_id, r.first_token_time, r.finish_time)
            for r in treqs] == [(r.engine_id, r.first_token_time,
                                 r.finish_time) for r in jreqs]
    assert plain(tinv) == plain(jinv)
    assert tres.signals["decisions"] == jres.signals["decisions"]
    assert plain(tres.signals) == plain(jres.signals)
    if name == "agentic_sessions":
        assert tinv["prefix_hit_tokens"] > 0


@pytest.mark.slow
def test_sim_real_differential(twin):
    """The reference's gate on the port's planes: identical finish sets,
    prefix-hit token totals and affinity decision counts, invariant pack
    green on both. ``fold_assistant=False`` keeps the two planes' radix
    trees token-identical (the sim plane cannot know real sampled
    tokens)."""
    kw = dict(rps=0.25, fold_assistant=False)
    real_reqs, rres, rinv = serve_slice(twin, TORCH, "agentic_sessions", 10,
                                        sequential=True, **kw)
    cfg, runner = twin(TORCH)
    sim_reqs = real_slice(TORCH, cfg, runner.ecfg, "agentic_sessions", 10,
                          sequential=True, **kw)
    assert [r.prompt_tokens for r in sim_reqs] == \
        [r.prompt_tokens for r in real_reqs]
    smetrics = TMetrics(window_s=5.0, seed=0)
    sres = simulate(sim_reqs,
                    SystemConfig(name="diff_sim", n_engines=2,
                                 n_moe_layers=4, n_experts=16, top_k=2),
                    engine_cfg=EngineConfig(kv_tokens=4096, kv_block=8,
                                            prefix_sharing=True),
                    traffic_seed=0, metrics=smetrics)
    sinv = tscen.check_scenario_invariants(sim_reqs, sres,
                                           engines=sres.engines,
                                           metrics=smetrics)
    assert sorted(r.req_id for r in real_reqs) == \
        sorted(r.req_id for r in sim_reqs)
    assert rinv["prefix_hit_tokens"] == sinv["prefix_hit_tokens"] > 0
    rdec, sdec = rres.signals["decisions"], sres.signals["decisions"]
    assert rdec.get("affinity_path", 0) == sdec.get("affinity_path", 0) > 0
    assert rinv["hit_rate"] == pytest.approx(sinv["hit_rate"])
