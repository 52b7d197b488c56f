"""Read the correctness check's two readings for a cell, on several seeds.

    python3 servebench/control.py --workload <cell> --seeds 11,12,13
        [--seconds 15]

For each seed, one run of the cell as the benchmark makes it (set-up,
ramp, a window of ``--seconds``), then, on the same sampled requests,
served tokens and prefill dispatches, every reading of both sides
(``check.read_numbers``): the program's (the gaps by which a served
token's reference logit lies below the reference's best, the share of
routed slots on another expert than the reference's router picks) and the
control's (the same for the tokens and routing of the architecture's fp8
forward, ``arch/<name>_ref.py`` driven by ``reference.py``). Then the
control in the program's place is judged by the harness's own comparison
(``check.judge``), against the cell's limits: ``control_correct`` has to
come out false. Each limit lies between the program's largest reading and
the control's smallest. The benchmark's own runs do not run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device: str, t0: float):
    from servebench import check, harness
    run = harness.run_cell(cell, seed, seconds, False, device, t0)
    numbers = check.read_numbers(run, device, control=True)
    judged = check.judge(run, device, control=True, numbers=numbers)
    return {"seed": seed, "requests": len(check.sample(run)),
            "stats_mismatches": check.stats_mismatches(run),
            "control_correct": judged["ok"], **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from servebench import harness
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(cell, seed, args.seconds, args.device,
                       time.perf_counter())
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
