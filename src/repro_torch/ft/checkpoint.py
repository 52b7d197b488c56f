"""Checkpoints: atomic, compressed, one file per array.

The reference's ``ft/checkpoint.py`` on its on-disk format, so either
package restores the other's checkpoints: a directory with
``manifest.json`` (step, tree description, per-leaf shape and dtype,
``extra``) and one ``leaf_%05d.zst`` per leaf. Leaves are stored in the
reference's pytree order (``bridge.tree_flatten``: dict keys sorted, lists
and NamedTuple fields in order). bfloat16 leaves are written as dtype
``"bfloat16"`` and their raw 16-bit words, and read back the same way, so
nothing here needs numpy's bfloat16 type. The port compresses with stdlib
``zlib``; a leaf that holds a zstd frame (written by an install with
``zstandard``) cannot be read here and raises. The directory swap is
atomic (write to ``.tmp``, then rename), so a crash mid-save never
corrupts the latest checkpoint.

Two halves: model checkpoints of any nesting of tensors
(``save_checkpoint``, ``restore_checkpoint``, ``checkpoint_step``: params,
or a whole ``TrainState``), and the serving control plane's snapshots
(``save_serving_state`` and its two readers). The reference's
``shardings=`` waits for ROADMAP.md Queue A item 11b (training under a
policy); ``restore_checkpoint`` takes a ``device`` in its place.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.bridge import tree_flatten, tree_unflatten

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_SERVING_KEYS = ("placement_assign", "profiler_A", "profiler_B")


def _decompress(data: bytes) -> bytes:
    if data[:4] == _ZSTD_MAGIC:
        raise RuntimeError(
            "checkpoint leaf is zstd-compressed; this package reads only "
            "zlib leaves (write the snapshot from an install without "
            "zstandard)")
    return zlib.decompress(data)


def _describe(tree) -> str:
    """A description of the nesting, in the spirit of the reference's
    treedef string (restore checks only the leaf count and shapes)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    return "*"


def _leaf_record(leaf):
    """-> (shape, dtype name, raw bytes) of a tensor, array or scalar."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return list(t.shape), "bfloat16", t.view(torch.int16).numpy() \
                .tobytes()
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return list(arr.shape), str(arr.dtype), arr.tobytes()


def _leaf_tensor(raw: bytes, meta: Dict) -> torch.Tensor:
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16) \
            .reshape(meta["shape"])
    arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
    return torch.from_numpy(arr.copy()).reshape(meta["shape"])


def save_checkpoint(path: str, tree: Any, *, step: int = 0,
                    extra: Optional[Dict] = None) -> str:
    """Atomic save of a nesting of tensors (or arrays). Returns the final
    directory."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tree_flatten(tree)
    manifest = {
        "step": int(step),
        "treedef": f"PyTreeDef({_describe(tree)})",
        "n_leaves": len(leaves),
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        shape, dtype, raw = _leaf_record(leaf)
        manifest["leaves"].append({"shape": shape, "dtype": dtype})
        with open(os.path.join(tmp, f"leaf_{i:05d}.zst"), "wb") as f:
            f.write(zlib.compress(raw, 3))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)          # atomic publish
    return path


def restore_checkpoint(path: str, like: Any, *, device=None) -> Any:
    """Restore into the nesting of ``like`` (leaf count and each shape
    checked, as the reference checks them). Each leaf comes back in its
    stored dtype, on ``device``, or where ``like``'s leaf lies when
    ``device`` is None (the CPU for a leaf that is not a tensor)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = tree_flatten(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(like_leaves)} — structure changed?")
    out = []
    for i, (meta, ref) in enumerate(zip(manifest["leaves"], like_leaves)):
        with open(os.path.join(path, f"leaf_{i:05d}.zst"), "rb") as f:
            t = _leaf_tensor(_decompress(f.read()), meta)
        if tuple(t.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                             f"{tuple(np.shape(ref))}")
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        out.append(t.to(dev))
    return tree_unflatten(like, out)


def checkpoint_step(path: str) -> Optional[int]:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["step"]


# ------------------------------------------------------- control-plane state
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
    return save_checkpoint(path, tree, step=step, extra=extra)


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
