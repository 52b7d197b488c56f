"""The architecture adapters: what the benchmark knows of one model family,
in two files of this directory, found by the configuration's
``model_type``.

``<name>.py``, the program side:

* ``MODEL_TYPES``: the configuration files' ``model_type``s it serves;
* ``model_config(cfg)``: the port's ``ModelConfig`` (it imports the port
  inside the function);
* ``checkpoint_leaves(path, shape, period)``: the slots (:class:`Slot`) of
  the port's leaf ``path`` (whole, as ``blocks.pos0.attn.wq`` or
  ``embed.embedding``) of shape ``shape``, in a port tree whose layer
  period is ``period`` layers: which part of the leaf holds which layer's
  checkpoint leaf, through which transform. The slots cover the leaf.
  :func:`period_slots` numbers a ``blocks.pos{j}`` leaf's super-blocks
  i * period + j; a leaf the port keeps outside the period (the model's
  own leaves, layer -1, or a layer of another kind ahead of the period)
  holds the layer the adapter names. It raises ``KeyError`` for a leaf it
  does not map;
* ``moe(cfg)``: the :class:`MoEShape`, or None for a model with no routed
  experts;
* ``model_flops(cfg, n_tokens, ctx_sum, n_logits)``: the FLOPs of a step
  over ``n_tokens`` tokens whose live contexts sum to ``ctx_sum``,
  ``n_logits`` of which go through the LM head (``metrics/step_mfu.py``).

``<name>_ref.py``, the reference side, which imports nothing of the
program:

* ``leaves(cfg, layer)``: leaf name -> (shape, kind, std) for
  ``weights.draw`` of layer ``layer`` (-1: the model's own leaves);
* the float32 forward, in the pieces that ``reference.served_gaps`` drives:
  ``embed(cfg, seed, toks, device)``, the sequences' first hidden states;
  ``layer(cfg, lp, xs, fp8)``, one layer over every sequence (``fp8``: the
  control's operands), returning the new states and, in a layer that
  routes, each token's experts; ``head(cfg, seed, device)``, the function
  from final hidden states to logits.

A new architecture is new files: these two, its configuration, and its
cells' entries in ``BENCHMARK.json``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent


class MoEShape(NamedTuple):
    """The routed experts: how many, how many a token, and the layers that
    route, in order (the rows of the program's per-layer statistics)."""
    experts: int
    top_k: int
    layers: Tuple[int, ...]


class Slot(NamedTuple):
    """Where one checkpoint leaf of one layer sits in a port leaf: at
    ``index`` of its leading axis (None: the whole leaf), drawn as
    ``name`` of layer ``layer`` (-1: the model's own) and passed through
    ``transform`` (None: as drawn)."""
    index: Optional[int]
    name: str
    layer: int
    transform: Optional[Callable] = None


_BLOCK_LEAF = re.compile(r"blocks\.pos(\d+)\.(.+)")


def period_slots(path: str, shape: Tuple[int, ...], period: int):
    """For the port's leaf ``blocks.pos{j}.<rel>``, stacked over its
    super-blocks on the leading axis: ``rel`` and the (index, layer) of
    each super-block i, layer i * period + j. None for a leaf outside
    ``blocks``."""
    m = _BLOCK_LEAF.fullmatch(path)
    if m is None:
        return None
    j = int(m[1])
    return m[2], [(i, i * period + j) for i in range(shape[0])]


@dataclasses.dataclass(frozen=True)
class Arch:
    """One adapter pair."""
    name: str
    program: ModuleType
    ref: ModuleType


def _load(path: Path) -> ModuleType:
    if path.parent == HERE:
        return importlib.import_module(f"{__name__}.{path.stem}")
    tag = hashlib.sha256(str(path.parent).encode()).hexdigest()[:12]
    name = f"servebench_arch_{tag}_{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def find(model_type: str, dirs: Sequence = ()) -> Arch:
    """The adapter pair that serves ``model_type``, among the program-side
    files of this directory and of ``dirs`` (for tests)."""
    found = [p for d in (HERE, *map(Path, dirs))
             for p in sorted(d.glob("*.py"))
             if not p.stem.startswith("_") and not p.stem.endswith("_ref")
             and model_type in _load(p).MODEL_TYPES]
    if len(found) != 1:
        raise LookupError(f"model_type {model_type!r}: {len(found)} "
                          f"adapters serve it ({[p.stem for p in found]})")
    p = found[0]
    return Arch(name=p.stem, program=_load(p),
                ref=_load(p.with_name(f"{p.stem}_ref.py")))
