"""Run one benchmark cell once and print its result as the last line.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

Run from the root of a checkout on a machine with as many CUDA devices as
the cell asks for. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared, with its limit); the checks are also the last lines of standard
error. With ``--trace 0`` the metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, each read by
``servebench/metrics/<name>.py``.

Exits with a code other than 0, and prints no result, when CUDA is missing
or has too few devices, when the program or the benchmark's files are
missing, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_paths() -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # caches of any kernel build at fixed paths inside the checkout; the
    # port's own CUDA libraries go to build/repro_torch_kernels/
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def read_metric(name: str, run):
    path = ROOT / "servebench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"servebench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def result(run, checks: dict, device: dict, trace: bool) -> dict:
    cell = run.cell
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    due = run.due_requests()
    out = {"correct": checks["ok"], "attempted": len(due),
           "failed": sum(1 for r in due if r.error), "metrics": metrics,
           "device": device}
    if trace:
        from servebench import trace as tr
        out["breakdown"] = tr.breakdown(run.trace)
    out["checks"] = checks["checks"]
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device: str,
            rounds=None):
    """One run: (the run's record, the checks, the device's description).
    ``rounds`` closes the window by rounds (the CPU tests)."""
    import torch
    from servebench import check, harness
    run = harness.run_cell(cell, seed, seconds, trace, device, T_START,
                           rounds)
    if device == "cuda":
        desc = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        desc = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace:
        from servebench import trace as tr
        run.trace = tr.reduce(run)
        run.rec.profiler = None
        desc["busy_s"] = run.trace["busy_s"]
        desc["window_s"] = run.trace["window_s"]
        harness.log("trace reduced", T_START)
    numbers = check.read_numbers(run, device)
    checks = check.judge(run, device, numbers=numbers)
    harness.log("reference compared: " + json.dumps(numbers.get("served")),
                T_START)
    return run, checks, desc


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        sys.stderr.write(f"check {name} {c['value']} limit {c['limit']}\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()
    import torch
    from servebench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"servebench: {args.workload} needs {cell.chips} "
                         "CUDA device(s); none or too few found\n")
        return 2
    run, checks, desc = measure(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda")
    out = result(run, checks, desc, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"servebench: loaded {', '.join(bad)}\n")
        return 3
    print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
