"""Roofline sweep, the reference's ``launch/roofline_run.py``: every
(arch x shape) cell of the single-pod mesh (or the debug mesh), rank 0's
program counted on one card (``launch/roofline.py``) as rank 0 of a
``fake`` world of the mesh's size.

Writes ``<outdir>/<arch>__<shape>.json``: the roofline terms
(``RooflineTerms.to_dict``, the reference's keys) and what was counted
(each depth's FLOPs, bytes and collective bytes, the collectives by kind,
the kernels' regions, the device). Runs on the card unless ``--device
cpu`` is given; without a card it fails.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline_run \\
      --arch qwen3-moe-30b-a3b [--shape decode_32k] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch.dryrun import abstract_mesh, execution_device


def record(terms, runs, device) -> dict:
    d = terms.to_dict()
    d["device"] = str(device)
    d["counted"] = [dataclasses.asdict(r) for r in runs]
    return d


def sweep(mesh, mesh_name, archs, shapes, *, device, seed=0,
          outdir=None, smoke=False) -> list:
    """Each cell's record (written to ``outdir`` when given), on ``mesh``:
    a mesh of ranks whose rank 0 runs on ``device``. ``smoke``: the smoke
    configs at cut shapes (``cells.resolve``)."""
    from repro_torch.launch.cells import resolve
    from repro_torch.launch.roofline import roofline_cell
    out = []
    for arch in archs:
        for shape in shapes:
            try:
                terms, runs = roofline_cell(*resolve(arch, shape, smoke),
                                            mesh, mesh_name, device=device,
                                            seed=seed)
                d = record(terms, runs, device)
                status = d["skip"] or (
                    f"{d['bottleneck']}-bound "
                    f"frac={d['roofline_fraction']:.3f} "
                    f"flops={d['flops_per_chip']:.6g} "
                    f"bytes={d['bytes_per_chip']:.6g} "
                    f"collective={d['collective_bytes_per_chip']:.6g}")
                print(f"[roofline] {arch} x {shape}: {status}", flush=True)
            except Exception as e:      # one cell's failure: record, go on
                traceback.print_exc()
                d = {"arch": arch, "shape": shape, "error": str(e)}
            out.append(d)
            if outdir is not None:
                with open(os.path.join(outdir, f"{arch}__{shape}.json"),
                          "w") as f:
                    json.dump(d, f, indent=2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in SHAPES])
    ap.add_argument("--debug-mesh", action="store_true")
    ap.add_argument("--outdir", default="experiments/bench_torch/roofline")
    ap.add_argument("--device", default=None,
                    help="where rank 0 runs (default: cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke config at shapes cut to "
                         "64 tokens and 32 rows (the CLI on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import make_fake_mesh
    device = execution_device(args.device)
    m = abstract_mesh(False, args.debug_mesh)
    mesh = make_fake_mesh(tuple(m.shape.values()), m.axis_names,
                          "cpu" if device == "cpu" else "cuda")
    os.makedirs(args.outdir, exist_ok=True)
    recs = sweep(mesh, ("debug_" if args.debug_mesh else "") + "pod16x16",
                 [args.arch] if args.arch else list_archs(),
                 [args.shape] if args.shape else [s.name for s in SHAPES],
                 device=device, outdir=args.outdir, smoke=args.smoke)
    failures = sum("error" in d for d in recs)
    print(f"[roofline] done ({failures} failures)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
