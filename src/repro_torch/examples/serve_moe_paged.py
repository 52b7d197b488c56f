"""Gimbal over the paged real data plane (the production-shaped runtime).

Two PagedRealEngine DP replicas serve a tiny MoE model end to end:
physical paged KV with block tables, chunked prefill under a per-step token
budget, batched block-table decode, preemption that reclaims pages and
recomputes, and truthful trace signals feeding Algorithm 1. The Gimbal
coordinator consumes REAL router statistics and migrates experts live.

With ``--shared-prefix`` every request carries a common 24-token system
prompt and the engines run the ``SharedPagedAllocator`` (ref-counted pages
+ radix-tree token-granular prefix cache + copy-on-write); the run is
repeated with sharing off to show pages saved, prefill skipped and the
TTFT delta — with bit-identical outputs. Under sharing the engines also
ship radix prefix summaries on their traces, so Algorithm 1's
prefix-affinity credit routes repeated prefixes to the engine already
holding them (the ``affinity`` dispatch count in the report).

With ``--chaos`` the same stream is served twice — fault-free, then under
a deterministic :class:`~repro_torch.ft.faults.FaultPlan` that crashes
engine 1 mid-run (KV pool lost) and recovers it later: the health monitor
fences the silent engine, its residents re-dispatch with emitted tokens
folded into resume prompts, and the run proves every request completes
bit-exact vs the fault-free pass.

PYTHONPATH=src python -m repro_torch.examples.serve_moe_paged \
    [--shared-prefix|--chaos] [--device cpu]

It runs on the card (``device="cuda"``) unless the caller asks for the CPU;
without a card and without ``--device cpu`` it raises.
"""
import dataclasses

import numpy as np

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.serving import (PagedEngineConfig, PagedModelRunner,
                           PagedRealEngine, RealClusterConfig, Request,
                           RequestState, serve_real_cluster)


def _requests(cfg, rng, n=12, system=None):
    reqs = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(8, 40))).tolist()
        if system is not None:
            toks = list(system) + toks[:12]
        reqs.append(Request(
            req_id=i, prompt_len=len(toks),
            max_new_tokens=int(rng.integers(4, 10)),
            arrival_time=0.05 * i, prompt_tokens=toks))
    return reqs


def _serve(cfg, params, runner, ecfg, reqs, **cluster_kw):
    engines = [PagedRealEngine(i, cfg, params, ecfg, runner=runner,
                               n_sources=2) for i in range(2)]
    res = serve_real_cluster(
        reqs, engines, cluster_cfg=RealClusterConfig(window_tokens=300,
                                                     **cluster_kw))
    for e in engines:
        e.pool.check_invariants()
    return res, engines


def _report(reqs, engines, res):
    done = [r for r in reqs if r.state is RequestState.FINISHED
            and not r.error]
    print(f"served {len(done)}/{len(reqs)} requests on {len(engines)} "
          f"paged engines ({res.signals['rounds']} cluster rounds)")
    print(f"dispatch decisions: {res.signals['decisions']}")
    print(f"prefill dispatches: {res.signals['prefill_dispatches']} "
          f"(avg {res.signals['prefill_lanes_per_dispatch']:.2f} "
          f"lanes fused per dispatch)")
    print(f"preemptions: {res.signals['preemptions']}  "
          f"stalls: {res.signals['stalled']}  "
          f"kv peak: {res.signals['kv_peak']:.1%}")
    print(f"expert migrations: {res.signals['migrations']} "
          f"({res.signals['expert_moves']} expert moves)")
    print(f"requests per engine: {res.signals['per_engine']}")
    print(f"mean ttft {res.mean_ttft:.2f}s  mean e2e {res.mean_e2e:.2f}s "
          f"(virtual time)")


def _chaos(cfg, params, runner, ecfg):
    """Crash engine 1 mid-run, recover it, prove nothing was lost."""
    from repro_torch.ft import FaultEvent, FaultPlan
    from repro_torch.ft.health import HealthConfig

    mk = lambda: _requests(cfg, np.random.default_rng(0))
    res0, _ = _serve(cfg, params, runner, ecfg, base := mk())
    want = {r.req_id: r.output_tokens for r in base}

    plan = FaultPlan(events=(FaultEvent("crash", 1, 10),
                             FaultEvent("recover", 1, 22)))
    res, engines = _serve(
        cfg, params, runner, ecfg, reqs := mk(), fault_plan=plan,
        health_cfg=HealthConfig(trace_timeout_s=0.3))

    print("== chaos: engine 1 crashes at round 10, recovers at 22 ==")
    _report(reqs, engines, res)
    print(f"health events: {res.signals['health_events']}")
    print(f"engine failures: {res.signals['n_failures']}  "
          f"requests recovered: {res.signals['recovered_requests']}  "
          f"recompute tokens: {res.signals['recovery_recompute_tokens']}")
    exact = all(r.full_output_tokens == want[r.req_id] for r in reqs)
    lost = [r.req_id for r in reqs
            if r.state is not RequestState.FINISHED or r.error]
    print(f"bit-exact vs fault-free: {exact}  lost/errored: {lost}")
    assert exact and not lost


def main(shared_prefix: bool = False, chaos: bool = False,
         device: str = "cuda", cfg=None):
    cfg = cfg or get_smoke_config("qwen3-moe-30b-a3b")
    params = build_model(cfg).init(torch.Generator(device).manual_seed(0),
                                   device=device)

    ecfg = PagedEngineConfig(page_size=8, n_pages=32, max_blocks_per_req=8,
                             max_batch=4, token_budget=16,
                             chunk_buckets=(8, 16), device=device)
    runner = PagedModelRunner(cfg, params, ecfg, n_sources=2)

    if chaos:
        _chaos(cfg, params, runner, ecfg)
        return
    if not shared_prefix:
        reqs = _requests(cfg, np.random.default_rng(0))
        res, engines = _serve(cfg, params, runner, ecfg, reqs)
        _report(reqs, engines, res)
        return

    # shared-system-prompt workload, sharing on vs off on the same stream
    system = np.random.default_rng(7).integers(0, cfg.vocab_size, 24)
    mk = lambda: _requests(cfg, np.random.default_rng(0), system=system)
    res_off, eng_off = _serve(cfg, params, runner, ecfg, reqs_off := mk())
    shared_cfg = dataclasses.replace(ecfg, prefix_sharing=True)
    res_on, eng_on = _serve(cfg, params, runner, shared_cfg,
                            reqs_on := mk())

    print("== sharing OFF ==")
    _report(reqs_off, eng_off, res_off)
    print("== sharing ON (ref-counted prefix cache + COW) ==")
    _report(reqs_on, eng_on, res_on)
    identical = all(a.output_tokens == b.output_tokens
                    for a, b in zip(reqs_off, reqs_on))
    saved = res_off.signals["pages_allocated"] \
        - res_on.signals["pages_allocated"]
    print(f"bit-identical outputs: {identical}")
    print(f"physical pages saved: {saved} "
          f"({res_on.signals['pages_allocated']} vs "
          f"{res_off.signals['pages_allocated']})")
    print(f"prefill tokens skipped via cache: "
          f"{res_on.signals['prefix_hit_tokens']}  "
          f"cow copies: {res_on.signals['cow_copies']}")
    print(f"affinity dispatches (prefix-holding engine picked): "
          f"{res_on.signals['decisions']['affinity_path']}  "
          f"per-engine hits: {res_on.signals['per_engine_prefix_hits']}")
    assert identical and saved > 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--shared-prefix", action="store_true",
                    help="shared-system-prompt workload with the "
                         "prefix-sharing allocator, vs a no-sharing run")
    ap.add_argument("--chaos", action="store_true",
                    help="crash engine 1 mid-run and recover it: fence, "
                         "re-dispatch, rejoin — bit-exact vs fault-free")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    _a = ap.parse_args()
    main(shared_prefix=_a.shared_prefix, chaos=_a.chaos, device=_a.device)
