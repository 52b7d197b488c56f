"""Find a cell's knee: the highest arrival rate, in requests per round, at
which the waiting backlog does not grow across the window.

    python3 servebench/sweep.py --workload <cell> --rates 1.6,2.0,2.4
        [--rounds 150] [--seed 1] [--shape-seeds 2026,1,2] [--layers 2]
        [--widths smoke --device cpu]

One set-up (build, weights, warm-up); then, for each rate and each of the
traffic's ``--shape-seeds`` (its sizes and arrivals; the mix's own by
default), the cell's traffic at that rate through the ramp and
``--rounds`` rounds. Prints one JSON line per rate and shape: the backlog
(requests due and still without a first token) at the window's first and
last round, its least-squares slope a round, its mean over the window's
first and last thirds, TTFT in rounds (and its median over the window's
first and second halves), the most KV pages an engine held, and the wall
seconds a round. The dynamics in rounds do not depend on the program's
speed: ``--layers`` serves fewer layers, and ``--widths smoke`` the
configuration's smoke-sized widths (with the cell's own engines and
traffic), to sweep faster or on the CPU.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def reading(run, quantile) -> dict:
    """The backlog, TTFT in rounds and the pool's peak of one swept run."""
    import numpy as np
    rec = run.rec
    rs = np.arange(rec.open_round, rec.close_round)
    due = np.array([q.due_round for q in rec.reqs.values()])
    first = np.array([q.first_round if q.first_round is not None
                      else 10 ** 9 for q in rec.reqs.values()])
    # requests due and still without a first token as each round begins
    b = np.array([((due <= r) & (first >= r)).sum() for r in rs],
                 dtype=float)
    third = max(len(rs) // 3, 1)
    reqs = run.due_requests()
    ttft = [(q.first_round if q.first_round is not None
             else rec.close_round) - q.due_round for q in reqs]
    half = rec.open_round + len(rs) // 2
    early = [t for t, q in zip(ttft, reqs) if q.due_round < half]
    late = [t for t, q in zip(ttft, reqs) if q.due_round >= half]
    return {
        "rounds": len(rs), "backlog_first": int(b[0]),
        "backlog_last": int(b[-1]), "backlog_max": int(b.max()),
        "backlog_slope": float(np.polyfit(rs - rs[0], b, 1)[0]),
        "backlog_mean_first_third": float(b[:third].mean()),
        "backlog_mean_last_third": float(b[-third:].mean()),
        "due": len(ttft), "ttft_rounds_p50": quantile(ttft, 0.5),
        "ttft_rounds_p90": quantile(ttft, 0.9),
        "ttft_rounds_p50_first_half": quantile(early, 0.5),
        "ttft_rounds_p50_second_half": quantile(late, 0.5),
        "kv_pages_peak": max(rec.kv_pages_peak.values()),
        "backlog": [int(x) for x in b],
        "s_per_round": run.window_s / len(rs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve this many layers of the model instead")
    ap.add_argument("--widths", choices=("full", "smoke"), default="full",
                    help="smoke: the configuration's smoke-sized model "
                    "(its widths, layers and vocabulary), the cell's engines")
    ap.add_argument("--shape-seeds", default="",
                    help="the traffic's shape seeds (default: the mix's)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from servebench import harness
    from servebench.stats import quantile
    cell = harness.load_cell(args.workload)
    if args.widths == "smoke":
        small = {k: v for k, v in cell.config["smoke"].items()
                 if k not in ("engine", "check")}
        cell = dataclasses.replace(cell, config=harness.merged(
            cell.config, small))
    if args.layers:
        cell = dataclasses.replace(cell, config=harness.merged(
            cell.config, {"num_hidden_layers": args.layers}))
    t0 = time.perf_counter()
    prog = harness.setup_program(cell, args.seed, args.device, t0)
    shapes = [int(x) for x in args.shape_seeds.split(",") if x] \
        or [int(cell.traffic["shape_seed"])]
    for rate in (float(x) for x in args.rates.split(",")):
        for shape in shapes:
            c = dataclasses.replace(cell, traffic=harness.merged(
                cell.traffic, {"arrivals": {"rate_per_round": rate},
                               "shape_seed": shape}))
            run = harness.serve(c, prog, args.seed, float("inf"), False, t0,
                                rounds=args.rounds)
            out = {"rate_per_round": rate, "shape_seed": shape}
            out.update(reading(run, quantile))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
