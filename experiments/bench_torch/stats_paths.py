"""Device time of the two paths of ``source_expert_count``, and of a
warp-aggregated variant of its single block, by size and routing skew.

    python3 experiments/bench_torch/stats_paths.py [--out FILE]

For 64 to 32768 slots (T tokens x K=8, E=128 experts, S=2 sources) and
three routings (random ids; 3 of 4 slots on expert 0; every slot on one
expert) it times, each call held to the plain version:

- ``block``: the single block (the path up to ``SINGLE_BLOCK_SLOTS``);
- ``grid``: two memsets and the grid of blocks (the path above it);
- ``match``: the single block with warp-aggregated counting
  (``stats_match.cu`` beside this script: the lanes of a warp that hold
  one bin are grouped with ``__match_any_sync``, and each group's size is
  added with one ``atomicAdd``).

The port's two paths are forced through the wrapper's
``single_block_slots``. Per call: event time and device time (``callsite_ab.device_ops``: torch.profiler, L2 flushed), and host
time, the median over 50 calls of the host clock around the call alone,
issued with the device idle: what the wrapper, its launch and any memsets
cost the host. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def build_match(ops):
    """Compile ``stats_match.cu`` (the warp-aggregated single block) with
    the port's nvcc flags into ``build/`` and return its launcher."""
    out = os.path.join(ROOT, "build", "stats_match", "libstats_match.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", out,
                    os.path.join(HERE, "stats_match.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(out).stats_match_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stats_paths: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT, HERE]
    import chip_smoke as cs
    from callsite_ab import device_ops
    from repro_torch.kernels import ops
    from repro_torch.kernels import source_expert_count as sec
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for slots in (64, 2048, 4096, 8192, 16384, 32768):
        T, K = slots // 8, 8
        for skew in ("random", "hot", "one"):
            ids = torch.randint(0, 128, (T, K), generator=g, device="cuda",
                                dtype=torch.int32)
            if skew == "hot":
                hot = torch.rand(T, K, generator=g, device="cuda") < 0.75
                ids = torch.where(hot, torch.zeros_like(ids), ids)
            elif skew == "one":
                ids.fill_(5)
            src = torch.randint(0, 2, (T,), generator=g, device="cuda",
                                dtype=torch.int32)
            cases.append((slots, skew, ids, src))
    kw = dict(n_experts=128, n_sources=2)
    results = []
    match = build_match(ops)

    def match_call(ids, src):
        b = torch.empty(128, dtype=torch.int32, device="cuda")
        a = torch.empty(2, 128, dtype=torch.int32, device="cuda")
        err = match(ids.data_ptr(), src.data_ptr(), b.data_ptr(),
                    a.data_ptr(), ids.shape[0], ids.shape[1], 128, 2, 0,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stats_match: CUDA error {err}")
        return b, a

    paths = {
        "block": lambda ids, src: sec.source_expert_count(
            ids, src, **kw, single_block_slots=1 << 30),
        "grid": lambda ids, src: sec.source_expert_count(
            ids, src, **kw, single_block_slots=-1),
        "match": match_call}
    for path, call in paths.items():
        for slots, skew, ids, src in cases:
            def fn():
                return call(ids, src)
            b, a = fn()
            rb, ra = sec.source_expert_count_plain(ids, src, **kw)
            if not (torch.equal(b, rb) and torch.equal(a, ra)):
                raise AssertionError(f"{path} at {slots} slots ({skew}) "
                                     "differs from the plain version")
            ms = timer(fn)
            dev, n_ops, _ = device_ops(timer, fn)
            host = []
            for _ in range(50):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host.append(time.perf_counter() - t0)
            host_ms = 1e3 * statistics.median(host)
            results.append({"path": path, "slots": slots, "skew": skew,
                            "ms": ms, "device_ms": dev, "device_ops": n_ops,
                            "host_ms": host_ms})
            print(f"{path} slots={slots} {skew}: event {ms:.4f} ms, device "
                  f"{dev:.4f} ms in {n_ops} operations, host {host_ms:.4f} "
                  f"ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
