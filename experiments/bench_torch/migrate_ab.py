"""Expert migration in place at llama4-maverick's full width, two ways, in
one process: gather the moved expert rows of each (layer, tensor) and
write them back with ``index_copy_`` (the port's first in-place design,
rebuilt here), against following each cycle of the permutation with a
buffer of one expert row (``models/moe.py::migrate_expert_weights``, what
the port runs).

    python3 experiments/bench_torch/migrate_ab.py [--out FILE] [--seed 0]

The model is ``reduced(get_config("llama4-maverick-400b-a17b"),
n_layers=2)`` in bf16 (34.79 GiB; one MoE layer of 128 experts of 5120 x
8192, 240 MiB an expert), random weights from ``--seed``. Three moves
from the identity placement: one swap of two experts, a cycle through
half the experts, and a random permutation (an adoption of the
uncalibrated placement in ``chip_smoke.py`` moves most of the 128). For
each, the two ways run in turns (gather, cycles, cycles, gather), each
from the identity and moved back after; each reports its wall ms (host
clock around the move, synchronized), the bytes of the moved rows, and
the rise of the card's peak memory over what was allocated before it.
Both ways must leave the same bits (per-expert fingerprints). Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def gather_move(params, cfg, old, new):
    """The moved rows of each (layer, tensor) gathered into one buffer,
    then written back with ``index_copy_``."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    for w in tfm.expert_stacks(params, cfg):
        dst, src = moe_mod.moved_slots(old[0], new[0])
        w0 = w[0]
        w0.index_copy_(0, dst.to(w0.device), w0[src.to(w0.device)])


def timed(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() - base)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("migrate_ab: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from chip_smoke import weight_fingerprint
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = reduced(get_config("llama4-maverick-400b-a17b"), n_layers=2)
    params = tfm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    E = cfg.moe.n_experts
    ewb = tfm.expert_weight_bytes(cfg)
    ident = np.arange(E)[None]
    rng = np.random.default_rng(args.seed)
    swap = ident.copy()
    swap[0, [1, E - 2]] = swap[0, [E - 2, 1]]
    half = ident.copy()
    half[0, :E // 2] = np.roll(half[0, :E // 2], 1)
    moves = {"one swap": swap, "cycle of half": half,
             "random permutation": rng.permutation(E)[None]}
    ways = {"gather": gather_move, "cycles": tfm.move_experts}
    results = []
    for what, new in moves.items():
        rows = int((new != ident).sum())
        prints = {}
        for way in ("gather", "cycles", "cycles", "gather"):
            ms, rise = timed(lambda: ways[way](params, cfg, ident, new))
            fp = weight_fingerprint(params)
            if way in prints and not all(
                    torch.equal(a, b) for a, b in zip(prints[way], fp)):
                raise AssertionError(f"{what}: {way} moved differently")
            prints[way] = fp
            tfm.move_experts(params, cfg, new, ident)          # back
            results.append({"move": what, "way": way, "rows": rows,
                            "bytes": rows * ewb, "ms": ms, "rise": rise})
            print(f"{what}: {way}: {rows} expert rows "
                  f"({rows * ewb / 2**20:.0f} MiB) in {ms:.2f} ms wall, "
                  f"peak rise {rise / 2**20:.1f} MiB", flush=True)
        if not all(torch.equal(a, b) for a, b in
                   zip(prints["gather"], prints["cycles"])):
            raise AssertionError(f"{what}: the two ways leave other bits")
    print(f"both ways leave the same bits in every move; {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "smi": smi,
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
