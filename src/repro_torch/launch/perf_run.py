"""Perf variants of the three chosen cells, timed on the card: the
reference's ``launch/perf_run.py``.

Each variant changes one knob of rank 0's program on the single-pod
(16, 16) mesh, run as rank 0 of a ``fake`` world (``launch/mesh.py``). For
each it prints the roofline terms (``launch/roofline.py``: counted at 1 and
2 super-blocks and extrapolated to full depth) and rank 0's step on the
card, which takes the place of XLA's estimate: the median of ``--iters``
(3) CUDA-event times after one untimed call, L2 not flushed, as a step
follows a step, with the least and the most beside it. A decode step is
timed at full depth: its per-layer time is a few ms, which the
extrapolation would multiply by the depth. Prefill and training steps are
timed at the two counted depths and extrapolated, their range from the
iterations' extremes. The step has no communication in it (the world is
fake), so the line prints it beside ``max(compute_s, memory_s)`` and the
modelled ``collective_s``. With ``--device cpu`` the counts run on the CPU
and the step is not timed; without a card and without ``--device cpu`` it
fails.

The reference's knobs map as follows:

* ``ragged_dispatch`` is the ``ragged=`` keyword of the entry points
  (``cells.build_cell(ragged=)``): the sorted ragged GMM, or the
  capacity-padded ``moe_gmm``;
* ``expert_rowparallel`` is a policy override. The port's MoE layer
  always keeps an expert's FFN dimension cut and sums the partial outputs
  (the row-parallel layout) and never gathers the weights, so the
  reference's ``v1_weight_gather`` has no counterpart and counts as the
  row-parallel layout;
* ``decode_regroup``, ``dispatch_constraints``, ``vmap_scatter`` and cache
  donation are XLA lowering choices (a regrouped decode dispatch, sharding
  constraints on the dispatch, a vmapped scatter, an aliased cache): eager
  PyTorch has no counterpart (the port's caches are written in place), so
  variants that differ only in them collapse into one. Collapsed:
  prefill_32k and decode_32k ``v0_baseline`` to ``v3_plus_cache_donation``
  (all padded) into ``v0-v3_padded``; train_4k ``v0_baseline_rowparallel``
  to ``v2_vmap_scatter`` (all padded) into ``v0-v2_padded``.

JSON records go to ``<outdir>/<arch>__<shape>__<variant>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf_run \\
      [--cell qwen3-moe-30b-a3b:decode_32k] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Dict

import torch

from repro_torch.launch.dryrun import execution_device
from repro_torch.launch.roofline import extrapolate

CELLS = {
    # (arch, shape): [(variant, ragged, policy overrides)]
    ("qwen3-moe-30b-a3b", "prefill_32k"): [
        ("v0-v3_padded", False, None),
        ("v4_ragged_dispatch", True, None),
    ],
    ("qwen3-moe-30b-a3b", "decode_32k"): [
        ("v0-v3_padded", False, None),
        ("v4_ragged_dispatch", True, None),
    ],
    ("llama4-maverick-400b-a17b", "train_4k"): [
        ("v0-v2_padded", False, {"expert_rowparallel": True}),
        ("v3_ragged_dispatch", True, {"expert_rowparallel": False}),
    ],
}


def time_step(live, iters: int) -> Dict[str, float]:
    """Rank 0's step of a live cell (``cells.materialize_cell``) on the
    card, after one untimed call: the median, least and most of ``iters``
    CUDA-event times, in ms."""
    live.fn(*live.args)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        live.fn(*live.args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def run_variant(arch, shape, name, ragged, overrides, mesh, *, device,
                iters=3, seed=0, smoke=False, timed=True) -> dict:
    """One variant's record: the roofline terms, the counted depths and,
    on the card and ``timed``, rank 0's step time (ms): a decode cell's at
    full depth, another's at the counted depths and extrapolated
    (``step_ms``, and ``step_ms_range`` from the iterations' extremes)."""
    from repro_torch.launch.cells import (build_cell, materialize_cell,
                                          resolve)
    from repro_torch.launch.roofline import roofline_cell
    from repro_torch.launch.roofline_run import record
    from repro_torch.models.transformer import n_super_blocks
    cfg, shp = resolve(arch, shape, smoke)
    terms, runs = roofline_cell(
        cfg, shp, mesh, "pod16x16", device=device,
        policy_overrides=overrides, ragged=ragged, seed=seed)
    d = record(terms, runs, device)
    d.update(variant=name, ragged=ragged, policy_overrides=overrides,
             step_ms=None, step_ms_range=None)
    if not (timed and runs and torch.device(device).type == "cuda"):
        return d
    cell = build_cell(cfg, shp, mesh, policy_overrides=overrides,
                      ragged=ragged)
    by = {}
    for k in [None] if shp.kind == "decode" else [r.n_super for r in runs]:
        g = torch.Generator(device=device).manual_seed(seed)
        live = materialize_cell(cell, mesh, generator=g, device=device,
                                n_super=k)
        by[k] = time_step(live, iters)
        del live
    d["step_ms_by_depth"] = {"full" if k is None else str(k): t
                             for k, t in by.items()}
    if len(by) == 1:
        (t,) = by.values()
        d["step_ms"], d["step_ms_range"] = t["median"], [t["min"], t["max"]]
    else:
        # the step's coefficient on the shallower depth's time is negative
        (a, ta), (b, tb) = by.items()
        ns = n_super_blocks(cfg)
        d["step_ms"] = extrapolate(ta["median"], tb["median"], ns, a, b)
        d["step_ms_range"] = [extrapolate(ta["max"], tb["min"], ns, a, b),
                              extrapolate(ta["min"], tb["max"], ns, a, b)]
    return d


def line(d: dict, prev=None) -> str:
    bound = max(d["compute_s"], d["memory_s"])
    step = "step not measured"
    if d["step_ms"] is not None:
        lo, hi = d["step_ms_range"]
        depth = "full depth" if "full" in d["step_ms_by_depth"] else \
            "extrapolated from " + " and ".join(d["step_ms_by_depth"]) + \
            " super-blocks"
        step = (f"step {d['step_ms']:.3f} ms ({lo:.3f} to {hi:.3f}; "
                f"{depth}; CUDA events, median after a warm-up, L2 warm)")
    s = (f"{d['variant']:22s} compute={d['compute_s']:.4e}s "
         f"memory={d['memory_s']:.4e}s collective={d['collective_s']:.4e}s "
         f"[{d['bottleneck']}] frac={d['roofline_fraction']:.4f} "
         f"useful={d['useful_flops_ratio']:.3f}; {step} vs "
         f"max(compute, memory) {bound * 1e3:.3f} ms + modelled collective "
         f"{d['collective_s'] * 1e3:.3f} ms")
    if prev is not None:
        dd = d[f"{prev['bottleneck']}_s"] / \
            max(prev[f"{prev['bottleneck']}_s"], 1e-30) - 1
        s += f"  (dominant-term {dd:+.1%} vs prev)"
    return s


def run_cells(mesh, *, device, cell=None, outdir=None, iters=3, seed=0,
              smoke=False) -> list:
    out = []
    for (arch, shape), variants in CELLS.items():
        if cell and cell != f"{arch}:{shape}":
            continue
        print(f"\n=== {arch} x {shape} ===", flush=True)
        prev = None
        for name, ragged, overrides in variants:
            d = run_variant(arch, shape, name, ragged, overrides, mesh,
                            device=device, iters=iters, seed=seed,
                            smoke=smoke)
            print(line(d, prev), flush=True)
            if outdir is not None:
                with open(os.path.join(
                        outdir, f"{arch}__{shape}__{name}.json"), "w") as f:
                    json.dump(d, f, indent=2)
            out.append(d)
            prev = d
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default="experiments/bench_torch/perf")
    ap.add_argument("--cell", default=None,
                    help="arch:shape to run a single cell")
    ap.add_argument("--device", default=None,
                    help="where rank 0 runs (default: cuda)")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed steps a depth, after one untimed")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at shapes cut to 64 tokens and "
                         "32 rows (the CLI on the CPU)")
    args = ap.parse_args(argv)
    if args.cell and tuple(args.cell.split(":")) not in CELLS:
        ap.error(f"--cell: one of {[':'.join(k) for k in CELLS]}")
    from repro_torch.launch.mesh import make_fake_mesh
    device = execution_device(args.device)
    mesh = make_fake_mesh((16, 16), ("data", "model"),
                          "cpu" if device == "cpu" else "cuda")
    os.makedirs(args.outdir, exist_ok=True)
    run_cells(mesh, device=device, cell=args.cell, outdir=args.outdir,
              iters=args.iters, smoke=args.smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
