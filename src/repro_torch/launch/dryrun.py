"""Dry run of every (arch x shape x mesh) cell, the reference's
``launch/dryrun.py``.

By default it is abstract and runs on the CPU in seconds: every cell is
built (``launch/cells.py``), every spec must divide the dimension it cuts
or leave it whole, and ``memory.argument_bytes`` is the exact bytes one
rank holds of the cell's args under their specs; ``fits_card`` compares it
with one H100's 80 GiB. This proves what the reference's lowering proves of
the distribution config, without devices.

``--execute`` runs rank 0's program of the cell once, on the card (or on
the CPU with ``--device cpu``), as rank 0 of a ``fake`` world of the
mesh's size (``launch/mesh.py::make_fake_mesh``): real compute and memory,
the communication only modelled. Its args are drawn at their local shapes
and must come to ``argument_bytes`` to the byte. It fills ``flops``,
``bytes_accessed`` (``launch/cost.py``: eager, unfused traffic) and
``collectives`` (``launch/collective_analysis.py``), ``memory.temp_bytes``
(the peak of ``torch.cuda.max_memory_allocated`` less the args' bytes; not
measured on the CPU) and ``memory.output_bytes``, and ``run_s``, the wall
time of the counted run (counting included), where the reference has
``compile_s``; ``launches`` are the kernels' launches in that run. A
process holds one world, so one ``--execute`` run covers one mesh. Without
a card and without ``--device cpu`` it fails.

Failures are collected, each cell's record is written to
``<outdir>/<arch>__<shape>__<mesh>.json``, and the CLI exits 1 if any cell
failed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch qwen3-moe-30b-a3b --shape decode_32k --execute [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch.cells import (argument_bytes, build_cell,
                                      cell_is_skipped, check_specs,
                                      resident_bytes, resolve, tensors)
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

CARD_BYTES = 80 * 2 ** 30        # one H100's HBM


def mesh_name(multi_pod: bool, debug_mesh: bool) -> str:
    return ("debug_" if debug_mesh else "") + (
        "pod2x16x16" if multi_pod else "pod16x16")


def abstract_mesh(multi_pod: bool, debug_mesh: bool):
    return (make_debug_mesh(multi_pod=multi_pod) if debug_mesh
            else make_production_mesh(multi_pod=multi_pod))


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count (and the tensor-core launches of
    those with two routes, as ``<name>:tc``)."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.kv_pack import pack_kv, unpack_kv
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ragged
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.source_expert_count import source_expert_count
    out = {}
    for name, fn in (("paged_decode", paged_decode),
                     ("moe_gmm_ragged", moe_gmm_ragged),
                     ("source_expert_count", source_expert_count),
                     ("pack_kv", pack_kv), ("unpack_kv", unpack_kv),
                     ("flash_decode", flash_decode), ("moe_gmm", moe_gmm)):
        out[name] = fn.launches
        if hasattr(fn, "tc_launches"):
            out[name + ":tc"] = fn.tc_launches
    return out


def _finite(out) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors(out)
               if t.is_floating_point())


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             debug_mesh: bool = False, *, mesh=None, device=None,
             seed: int = 0, smoke: bool = False) -> Dict:
    """One cell's record. ``mesh``: a mesh of ranks to execute rank 0's
    program on (``--execute``), on ``device``; None: abstract. ``smoke``:
    the arch's smoke config at a cut shape (``cells.resolve``)."""
    name = mesh_name(multi_pod, debug_mesh)
    cfg, shape = resolve(arch, shape_name, smoke)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "family": cfg.family, "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    skip = cell_is_skipped(cfg, shape)
    tag = f"{arch}__{shape_name}__{name}"
    if skip:
        rec.update(status="SKIP", skip_reason=skip)
        print(f"[dryrun] {tag}: SKIP ({skip})")
        return rec
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh if mesh is not None
                      else abstract_mesh(multi_pod, debug_mesh))
    check_specs(cell)
    args_bytes = argument_bytes(cell)
    t1 = time.time()
    rec.update(status="OK", lower_s=t1 - t0, run_s=None, flops=None,
               bytes_accessed=None,
               memory={"argument_bytes": args_bytes, "output_bytes": None,
                       "temp_bytes": None, "generated_code_bytes": 0},
               fits_card=args_bytes <= CARD_BYTES, collectives=None)
    if mesh is None:
        print(f"[dryrun] {tag}: OK, {args_bytes / 2 ** 30:.3f} GiB of args "
              f"a rank ({'fits' if rec['fits_card'] else 'exceeds'} 80 GiB)")
        return rec
    rec.update(_execute(cell, mesh, device, seed, args_bytes))
    print(f"[dryrun] {tag}: executed rank 0 on {device} in "
          f"{rec['run_s']:.2f} s: {rec['flops']:.4g} FLOPs, "
          f"{rec['bytes_accessed']:.4g} bytes, "
          f"{rec['collective_bytes']:.4g} collective bytes, args "
          f"{args_bytes} bytes, temp {rec['memory']['temp_bytes']}")
    return rec


def _execute(cell, mesh, device, seed, args_bytes) -> Dict:
    from repro_torch.launch.cells import materialize_cell
    from repro_torch.launch.collective_analysis import count_collectives
    from repro_torch.launch.cost import count_costs
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=device).manual_seed(seed)
    live = materialize_cell(cell, mesh, generator=g, device=device)
    held = resident_bytes(live.args)
    if held != args_bytes:
        raise AssertionError(f"the drawn args hold {held} bytes, their "
                             f"specs {args_bytes}")
    before = launch_counts()
    t0 = time.time()
    with count_costs() as c, count_collectives() as coll:
        out = live.fn(*live.args)
        if cuda:
            torch.cuda.synchronize()
    run_s = time.time() - t0
    after = launch_counts()
    if not _finite(out):
        raise AssertionError("rank 0's outputs are not finite")
    arg_ptrs = {t.data_ptr() for t in tensors(live.args)}
    out_bytes = sum(t.numel() * t.element_size() for t in tensors(out)
                    if t.data_ptr() not in arg_ptrs)
    temp = torch.cuda.max_memory_allocated() - base - held if cuda else None
    return {"run_s": run_s, "device": str(device), "flops": c.flops,
            "bytes_accessed": c.bytes, "collective_bytes": c.collective_bytes,
            "collectives": coll, "kernels": c.kernels, "ops": c.ops,
            "launches": {k: after[k] - before[k] for k in after},
            "memory": {"argument_bytes": args_bytes,
                       "resident_arg_bytes": held, "output_bytes": out_bytes,
                       "temp_bytes": temp, "generated_code_bytes": 0}}


def execution_device(device: Optional[str]) -> str:
    """The device a counted run uses: the card unless the caller asks for
    the CPU; no card and no ``cpu`` is an error, never a fallback."""
    device = device or "cuda"
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: --execute runs on the card; pass "
                         "--device cpu to run rank 0 on the CPU")
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="tiny mesh for local iteration")
    ap.add_argument("--outdir", default="experiments/bench_torch/dryrun")
    ap.add_argument("--execute", action="store_true",
                    help="run rank 0's program on a fake world of the "
                         "mesh's size, under the counters")
    ap.add_argument("--device", default=None,
                    help="where --execute runs rank 0 (default: cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke config at shapes cut to "
                         "64 tokens and 32 rows (the CLI on the CPU)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s.name) for a in list_archs() for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    mesh = device = None
    if args.execute:
        from repro_torch.launch.mesh import make_fake_mesh
        device = execution_device(args.device)
        m = abstract_mesh(args.multi_pod, args.debug_mesh)
        mesh = make_fake_mesh(tuple(m.shape.values()), m.axis_names,
                              "cpu" if device == "cpu" else "cuda")
    elif args.device:
        ap.error("--device applies to --execute")
    os.makedirs(args.outdir, exist_ok=True)
    name = mesh_name(args.multi_pod, args.debug_mesh)
    failures = []
    for arch, shape_name in cells:
        try:
            rec = run_cell(arch, shape_name, args.multi_pod, args.debug_mesh,
                           mesh=mesh, device=device,
                           smoke=args.smoke)
        except Exception as e:      # one cell's failure: record, go on
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape_name, "mesh": name,
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
            failures.append((arch, shape_name, str(e)))
        with open(os.path.join(args.outdir,
                               f"{arch}__{shape_name}__{name}.json"),
                  "w") as f:
            json.dump(rec, f, indent=2)
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e[:200]}")
        return 1
    print("\n[dryrun] all cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
