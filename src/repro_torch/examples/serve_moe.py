"""End-to-end Gimbal serving driver (the paper's system, real data plane).

Two DP engines serve a real tiny MoE model with batched requests. The full
coordinated loop runs: pressure-aware dispatch (Algorithm 1), SJF+aging
local queues (Algorithm 2), REAL source-DP-to-expert statistics from the
router, source-aware expert placement with migration, and MoE-pressure
feedback into dispatch.

PYTHONPATH=src python -m repro_torch.examples.serve_moe [--device cpu]

It runs on the card (``device="cuda"``) unless the caller asks for the CPU;
without a card and without ``--device cpu`` it raises.
"""
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import (CoordinatorConfig, GimbalCoordinator,
                        GimbalScheduler, TraceTable)
from repro_torch.models import build_model
from repro_torch.models.transformer import (identity_placement,
                                      migrate_params_for_placement)
from repro_torch.serving.real_engine import RealModelEngine
from repro_torch.serving.request import Request, RequestState
from repro_torch.workloads import generate_trace


def main(device: str = "cuda"):
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    fns = build_model(cfg)
    params = fns.init(torch.Generator(device).manual_seed(0), device=device)

    n_engines, n_ranks = 2, 4
    engines = [RealModelEngine(i, cfg, params, max_slots=4, max_len=96,
                               n_sources=n_engines, device=device)
               for i in range(n_engines)]
    table = TraceTable(range(n_engines))
    sched = GimbalScheduler(table)
    coord = GimbalCoordinator(
        cfg.n_moe_layers, cfg.moe.n_experts, n_ranks, n_engines,
        cfg=CoordinatorConfig(window_tokens=400))

    reqs = generate_trace("two_end", 12, rps=50.0, seed=0, mean_output=12)
    rng = np.random.default_rng(0)
    for r in reqs:
        r.prompt_len = min(r.prompt_len % 24 + 4, 48)
        r.max_new_tokens = min(r.max_new_tokens, 16)
        r.prompt_tokens = rng.integers(
            0, cfg.vocab_size, r.prompt_len).tolist()

    t0 = time.time()
    pending = list(reqs)
    now = 0.0
    migrations = 0
    cur_perms = identity_placement(cfg).numpy()
    while pending or any(e.has_work for e in engines):
        now = time.time() - t0
        # dispatch arrivals due by now (Algorithm 1 against live traces)
        for r in list(pending):
            if r.arrival_time <= now * 50:     # compress sim time
                eid = sched.select_engine(r.prompt_len, now)
                engines[eid].enqueue(r, now)
                pending.remove(r)
        for e in engines:
            e.step(now)
            table.report(e.trace(now), now=now)
            sched.on_trace_refresh(e.engine_id)
            B, A = e.window_stats()
            if B is not None:
                coord.profiler.record_step(B, A, n_tokens=int(B.sum())
                                           // max(cfg.n_moe_layers, 1)
                                           // max(cfg.moe.top_k, 1))
        migrated, dur = coord.maybe_rebalance(now)
        if migrated:
            migrations += 1
            perms = np.asarray(coord.placement.permutations())
            # adopting a placement MOVES the weights: permute the stacked
            # expert params alongside the routing table
            params = migrate_params_for_placement(params, cfg,
                                                  cur_perms, perms)
            cur_perms = perms
            for e in engines:
                e.params = params
                e.placement = perms
                e.moe_pressure = coord.engine_moe_pressure(e.engine_id)
            print(f"[t={now:5.1f}s] expert migration #{migrations} "
                  f"({coord.migration_log[-1]['moves']} moves, "
                  f"{dur:.2f}s modeled)")

    done = [r for r in reqs if r.state is RequestState.FINISHED]
    print(f"\nserved {len(done)}/{len(reqs)} requests on {n_engines} engines "
          f"in {time.time()-t0:.1f}s wall")
    print(f"dispatch decisions: {sched.decisions}")
    print(f"expert migrations: {migrations} "
          f"({coord.placement.n_migrations} expert moves)")
    by_engine = {e.engine_id: sum(1 for r in done
                                  if r.engine_id == e.engine_id)
                 for e in engines}
    print(f"requests per engine: {by_engine}")
    B, A = coord.profiler.snapshot(reset=False)
    if A.sum() > 0:
        print(f"cross-DP traffic fraction under final placement: "
              f"{coord.cross_dp_fraction(A):.1%}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
