"""Fault tolerance walkthrough: engine failure, re-dispatch, checkpoint
restart, elastic scale-up — control-plane mechanics on synthetic traces,
then the real thing: a paged engine crashes mid-decode, its requests are
exported with emitted tokens folded into resume prompts, and the restarted
engine continues the streams bit-exact.

PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo \
    [--device cpu]
(full cluster chaos run: python -m repro_torch.launch.serve --real --paged
--chaos)

It runs on the card (``device="cuda"``) unless the caller asks for the CPU;
without a card and without ``--device cpu`` it raises. The reference's
``PagedEngineConfig(attn_backend="xla")`` has no counterpart here: on the
card the paged engine decodes through the ``paged_decode`` kernel.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.bridge import tree_flatten
from repro_torch.configs import get_smoke_config, reduced
from repro_torch.core import EngineTrace, GimbalScheduler, TraceTable
from repro_torch.ft import (ElasticController, EngineHealthMonitor,
                            HealthConfig, restore_checkpoint, save_checkpoint)
from repro_torch.models import build_model


def main(device: str = "cuda", cfg=None):
    """``cfg``: the real plane's model (default: the smoke qwen3-moe cut to
    2 layers, as the reference's demo)."""
    # ---- engine failure + re-dispatch
    table = TraceTable([0, 1, 2])
    sched = GimbalScheduler(table)
    for e in range(3):
        table.report(EngineTrace(e), now=0.0)
    moved = []
    mon = EngineHealthMonitor(table, sched, HealthConfig(trace_timeout_s=1.0),
                              redispatch=lambda e: moved.append(e) or 3)
    table.report(EngineTrace(0), now=5.0)
    table.report(EngineTrace(1), now=5.0)   # engine 2 goes silent
    down = mon.check(now=5.0)
    print(f"health: engines down = {down}, requests re-dispatched from "
          f"{moved}")
    picks = {sched.select_engine(100, 5.0) for _ in range(6)}
    print(f"dispatch now avoids engine 2: picks = {sorted(picks)}")
    table.report(EngineTrace(2), now=6.0)   # engine recovers
    mon.check(now=6.0)
    picks = {sched.select_engine(100, 6.0) for _ in range(6)}
    print(f"after rejoin: {sorted(picks)}")

    # ---- checkpoint / restart
    ck_cfg = get_smoke_config("qwen3-8b")
    params = build_model(ck_cfg).init(torch.Generator(device).manual_seed(0),
                                      device=device)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt")
        save_checkpoint(path, params, step=123)
        restored = restore_checkpoint(path, params)
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_flatten(params), tree_flatten(restored)))
        print(f"checkpoint roundtrip exact: {same}")

    # ---- elastic scale-up/down
    ec = ElasticController(table, sched)
    ec.scale_up(3, now=7.0)
    print(f"scaled up: engines = {table.engine_ids} "
          f"(new engine covered by ordered dispatch until first trace)")
    ec.scale_down(1, now=8.0, drain=lambda e: 2)
    print(f"scaled down engine 1: engines = {table.engine_ids}")
    print(f"elastic log: {ec.log}")

    # ---- real plane: crash a paged engine mid-decode, resume bit-exact
    import numpy as np

    from repro_torch.serving import PagedEngineConfig, PagedRealEngine, Request
    cfg = cfg or reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2)
    params = build_model(cfg).init(torch.Generator(device).manual_seed(0),
                                   device=device)
    ecfg = PagedEngineConfig(page_size=8, n_pages=32, max_blocks_per_req=8,
                             max_batch=4, token_budget=16,
                             chunk_buckets=(8, 16), device=device)

    def mk():
        return Request(req_id=0, prompt_len=12, max_new_tokens=6,
                       arrival_time=0.0,
                       prompt_tokens=np.random.default_rng(3).integers(
                           0, cfg.vocab_size, 12).tolist())

    def drive(e, t=0.0):
        while e.has_work:
            e.step(t)
            t += 0.01

    eng = PagedRealEngine(0, cfg, params, ecfg, n_sources=1)
    ref = mk()
    eng.enqueue(ref, 0.0)
    drive(eng)
    print(f"\nreal plane — uninterrupted stream: {ref.output_tokens}")

    req = mk()
    eng.enqueue(req, 0.0)
    for i in range(4):                      # partway through decode
        eng.step(0.01 * i)
    exported = eng.fail(0.04)               # KV pool lost
    print(f"crash mid-decode: exported {len(exported)} request(s), "
          f"emitted so far {req.resume_output}, resume prompt "
          f"{req.prompt_len} tokens (= 12 prompt + emitted)")
    eng.restart()
    eng.enqueue(req, 0.1)
    drive(eng, 0.1)
    print(f"after restart+resume:        {req.full_output_tokens}")
    print(f"bit-exact continuation: "
          f"{req.full_output_tokens == ref.output_tokens}")
    assert req.full_output_tokens == ref.output_tokens


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
