"""Serving control-plane snapshots: atomic, compressed, one file per array.

The serving-state half of the reference's ``ft/checkpoint.py``, on the
same on-disk format, so either package restores the other's snapshots: a
directory with ``manifest.json`` (step, tree description, per-leaf shape
and dtype, ``extra``) and one ``leaf_%05d.zst`` per array. Leaves are
stored in sorted-key order, the order in which the reference's pytree
flattening walks a dict. The port compresses with stdlib ``zlib``; a leaf
that holds a zstd frame (written by an install with ``zstandard``) cannot
be read here and raises. The directory swap is atomic (write to ``.tmp``,
then rename), so a crash mid-save never corrupts the latest snapshot.

Model checkpoints of torch trees are later work (ROADMAP.md Queue A).
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional

import numpy as np

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_SERVING_KEYS = ("placement_assign", "profiler_A", "profiler_B")


def _decompress(data: bytes) -> bytes:
    if data[:4] == _ZSTD_MAGIC:
        raise RuntimeError(
            "checkpoint leaf is zstd-compressed; this package reads only "
            "zlib leaves (write the snapshot from an install without "
            "zstandard)")
    return zlib.decompress(data)


def _save_leaves(path: str, tree: Dict[str, np.ndarray], *, step: int,
                 extra: Dict) -> str:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    keys = sorted(tree)
    manifest = {
        "step": step,
        "treedef": "PyTreeDef({" + ", ".join(f"'{k}': *" for k in keys)
                   + "})",
        "n_leaves": len(keys),
        "leaves": [],
        "extra": extra,
    }
    for i, k in enumerate(keys):
        arr = np.ascontiguousarray(np.asarray(tree[k]))
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, f"leaf_{i:05d}.zst"), "wb") as f:
            f.write(zlib.compress(arr.tobytes(), 3))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)          # atomic publish
    return path


def checkpoint_step(path: str) -> Optional[int]:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["step"]


def save_serving_state(path: str, *, placement_assign: np.ndarray,
                       profiler_B: np.ndarray, profiler_A: np.ndarray,
                       scheduler_comp: Dict[int, float],
                       traces: Optional[Dict] = None,
                       step: int = 0) -> str:
    """Snapshot the serving control plane: expert placement, profiler
    window, scheduler compensation and (optionally) the latest trace
    scalars (``TraceTable.scalar_snapshot``) — everything a restarted
    coordinator needs to resume with learned state instead of cold block
    layout and fallback dispatch."""
    tree = {
        "placement_assign": placement_assign,
        "profiler_B": profiler_B,
        "profiler_A": profiler_A,
    }
    extra: Dict[str, Any] = {
        "scheduler_comp": {str(k): v for k, v in scheduler_comp.items()}}
    if traces is not None:
        extra["traces"] = {str(k): v for k, v in traces.items()}
    return _save_leaves(path, tree, step=step, extra=extra)


def restore_serving_extra(path: str) -> Dict:
    """The full ``extra`` manifest dict of a serving-state checkpoint
    (scheduler compensation, trace scalars, ...) without loading leaves."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["extra"]


def restore_serving_state(path: str):
    """-> ({placement_assign, profiler_A, profiler_B} arrays of their
    stored shape and dtype, scheduler compensation {engine: float})."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["n_leaves"] != len(_SERVING_KEYS):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(_SERVING_KEYS)} — not a serving-state snapshot?")
    tree = {}
    for i, (key, meta) in enumerate(zip(_SERVING_KEYS, manifest["leaves"])):
        with open(os.path.join(path, f"leaf_{i:05d}.zst"), "rb") as f:
            raw = _decompress(f.read())
        arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(
            meta["shape"])
        tree[key] = arr.copy()
    comp = {int(k): v for k, v in
            manifest["extra"].get("scheduler_comp", {}).items()}
    return tree, comp
