"""Serving launcher: simulated cluster (paper-scale sweeps) or real tiny
data plane.

  PYTHONPATH=src python -m repro_torch.launch.serve --system gimbal \
      --dist random --rps 4 --requests 200
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --scenario agentic_sessions --requests 5000   # registered scenario
  PYTHONPATH=src python -m repro_torch.launch.serve --sessions \
      --requests 2000 --mean-turns 4 --rps 8       # ad-hoc multi-turn trace
  PYTHONPATH=src python -m repro_torch.launch.serve --real   # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --real --paged \
      --device cpu                                 # plain versions, on the CPU
"""
from __future__ import annotations

import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--system", default="gimbal",
                    help="vllm|moetuner|semmoe|gimbal|gimbal_dp|gimbal_ep|"
                         "gimbal_nocollab|gimbal_uncalibrated")
    ap.add_argument("--dist", default="random")
    ap.add_argument("--rps", type=float, default=4.0)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mean-output", type=int, default=250)
    ap.add_argument("--scenario", default="",
                    help="serve a registered stress scenario "
                         "(workloads/scenarios.py) with the invariant "
                         "pack on; see repro_torch.launch.stress --list")
    ap.add_argument("--sessions", action="store_true",
                    help="multi-turn session trace (grown-prefix "
                         "re-arrivals on the prefix-sharing allocator) "
                         "instead of a one-shot --dist trace")
    ap.add_argument("--mean-turns", type=float, default=4.0,
                    help="with --sessions: mean turns per session")
    ap.add_argument("--max-turns", type=int, default=12,
                    help="with --sessions: turn cap per session")
    ap.add_argument("--think-time", type=float, default=2.0,
                    help="with --sessions: mean think time between turns")
    ap.add_argument("--real", action="store_true",
                    help="serve a real tiny MoE model end to end")
    ap.add_argument("--paged", action="store_true",
                    help="with --real: use the paged KV runtime "
                         "(block-table decode, chunked prefill, preemption)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="with --real --paged: shared-system-prompt "
                         "workload on the prefix-sharing allocator "
                         "(ref-counted pages + COW), vs a no-sharing run")
    ap.add_argument("--chaos", action="store_true",
                    help="with --real --paged: crash an engine mid-run "
                         "and recover it — fence, re-dispatch, rejoin, "
                         "bit-exact outputs vs the fault-free pass")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="with --real: run the kernels on the card (cuda) "
                         "or their plain versions on the CPU")
    args = ap.parse_args()
    if args.shared_prefix and not (args.real and args.paged):
        ap.error("--shared-prefix requires --real --paged")
    if args.chaos and not (args.real and args.paged):
        ap.error("--chaos requires --real --paged")
    if args.scenario and (args.sessions or args.real):
        ap.error("--scenario already fixes the workload; "
                 "drop --sessions/--real")

    if args.scenario:
        from repro_torch.workloads.scenarios import get_scenario, run_scenario
        dash, _ = run_scenario(get_scenario(args.scenario), args.requests,
                               seed=args.seed)
        print(json.dumps(dash, indent=2, default=float))
        return

    if args.real:
        if args.paged:
            from repro_torch.examples.serve_moe_paged import main as real_main
            real_main(shared_prefix=args.shared_prefix, chaos=args.chaos,
                      device=args.device)
        else:
            from repro_torch.examples.serve_moe import main as real_main
            real_main(device=args.device)
        return

    from repro_torch.serving import PAPER_SYSTEMS, simulate
    if args.sessions:
        from repro_torch.serving import EngineConfig
        from repro_torch.workloads import SessionConfig, generate_sessions
        cfg = SessionConfig(mean_turns=args.mean_turns,
                            max_turns=args.max_turns,
                            think_time_s=args.think_time)
        mean_turns = min(cfg.mean_turns, float(cfg.max_turns))
        trace = generate_sessions(args.requests,
                                  args.rps / max(mean_turns, 1.0), cfg,
                                  seed=args.seed)
        engine_cfg = EngineConfig(prefix_sharing=True)
    else:
        from repro_torch.workloads import generate_trace
        trace = generate_trace(args.dist, args.requests, rps=args.rps,
                               seed=args.seed, mean_output=args.mean_output)
        engine_cfg = None
    res = simulate(trace, PAPER_SYSTEMS[args.system],
                   engine_cfg=engine_cfg, traffic_seed=args.seed)
    print(json.dumps({
        "system": args.system,
        "dist": "sessions" if args.sessions else args.dist,
        "rps": args.rps, "seed": args.seed,
        "ttft_s": res.mean_ttft, "p99_ttft_s": res.p99_ttft,
        "tpot_ms": res.mean_tpot * 1e3, "e2e_s": res.mean_e2e,
        "throughput_rps": res.throughput, "signals": res.signals,
    }, indent=2, default=str))


if __name__ == "__main__":
    main()
