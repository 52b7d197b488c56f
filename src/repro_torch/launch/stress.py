"""Scenario stress launcher: registered scenarios at 10^5-10^6 requests.

  PYTHONPATH=src python -m repro_torch.launch.stress --list
  PYTHONPATH=src python -m repro_torch.launch.stress \
      --scenario agentic_sessions --requests 100000 --seed 7
  PYTHONPATH=src python -m repro_torch.launch.stress --scenario all \
      --requests 100000 --budget-s 3600 \
      --out experiments/bench_torch/stress.json

Each run serves the scenario on the simulated plane with streaming
percentile metrics (O(1) memory — 10^6 requests never hold raw latency
arrays) and asserts the scenario invariant pack, so a stress sweep
doubles as a long-horizon property test. The per-scenario dashboard
records p50/p99 TTFT/TPOT/E2E plus scheduler/cache/swap telemetry;
``--series`` adds the windowed time series (dashboard plots).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> None:
    from repro_torch.workloads.scenarios import SCENARIOS, run_scenario
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="agentic_sessions",
                    help="registered scenario name, or 'all'")
    ap.add_argument("--requests", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--series", action="store_true",
                    help="include the windowed time series in the output")
    ap.add_argument("--budget-s", type=float, default=0.0,
                    help="fail (exit 1) if total wall clock exceeds this")
    ap.add_argument("--out", default="",
                    help="write the dashboard JSON here (default: stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args()

    if args.list:
        for name, s in sorted(SCENARIOS.items()):
            print(f"{name:24s} [{s.kind:7s}] {s.description}")
        return

    names = sorted(SCENARIOS) if args.scenario == "all" \
        else [args.scenario]
    t0 = time.perf_counter()
    dashboards = []
    for name in names:
        dash, _ = run_scenario(SCENARIOS[name], args.requests,
                               seed=args.seed, series=args.series)
        dashboards.append(dash)
        print(f"# {name}: {dash['n_requests']} requests in "
              f"{dash['wall_s']:.1f}s wall, p50/p99 TTFT "
              f"{dash['latency']['ttft']['p50']:.3f}/"
              f"{dash['latency']['ttft']['p99']:.3f}s, "
              f"hit_rate {dash['cache']['hit_rate']:.3f}",
              file=sys.stderr)
    wall = time.perf_counter() - t0
    payload = {"requests_per_scenario": args.requests, "seed": args.seed,
               "wall_s": wall, "scenarios": dashboards}
    text = json.dumps(payload, indent=2, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"# wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    if args.budget_s and wall > args.budget_s:
        print(f"# FAIL: wall {wall:.0f}s exceeds budget {args.budget_s:.0f}s",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
