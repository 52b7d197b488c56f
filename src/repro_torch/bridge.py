"""Bridge between the reference's numpy view of its pytrees and the port.

``config_from_dict`` rebuilds a :class:`ModelConfig` from
``dataclasses.asdict`` of the reference's config; ``params_from_numpy`` /
``params_to_numpy`` convert a params tree leaf by leaf, keeping every shape
and the nesting of dicts and lists (the transformer's ``embed/...``,
``blocks/pos{j}/...`` stacked ``(n_super, ...)``, ``final_norm``; xLSTM's
lists ``blocks`` and ``block_norms``, one entry a block; the
encoder-decoder's ``enc``/``dec`` stacked ``(n_layers, ...)``), so expert
migration and weight comparison stay one-to-one between the two
packages.

bfloat16 leaves arrive as numpy arrays of the ``ml_dtypes`` bfloat16 type,
which ``torch.from_numpy`` refuses. They cross as their raw 16-bit pattern
(``view(uint16)`` -> ``view(torch.bfloat16)``): lossless, and nothing is
imported for it.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig


def config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    """``dataclasses.asdict(cfg)`` of a reference ModelConfig -> the port's."""
    d = dict(d)
    d["moe"] = MoEConfig(**d["moe"])
    d["ssm"] = SSMConfig(**d["ssm"])
    return ModelConfig(**d)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nesting of dicts and lists, keeping
    the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a nesting of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_flatten(tree) -> list:
    """The leaves in the reference's pytree order: dict keys sorted, lists,
    tuples and NamedTuple fields in order, ``None`` holding no leaf (the
    order of its checkpoints and of ``jax.tree.leaves``). Unlike
    :func:`tree_leaves`, tuples are nodes here."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The nesting of ``like`` (dicts keep their key order) with its leaves
    taken from ``leaves``, given in :func:`tree_flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def _leaf_to_torch(arr, device) -> torch.Tensor:
    # a private copy: the port updates tensors in place, and the source may
    # be a read-only view of another framework's buffer
    a = np.array(np.asarray(arr), order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        # only a host that has the reference's numpy bfloat16 type can hold
        # such an array; the port itself never needs it
        bf16 = importlib.import_module("ml_dtypes").bfloat16
        return t.view(torch.int16).numpy().view(np.uint16).view(bf16)
    return t.numpy()


def params_from_numpy(tree, device="cuda"):
    """Nested dicts and lists of arrays (numpy, or anything ``np.asarray``
    takes) -> the same nesting of tensors on ``device``."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def params_to_numpy(tree):
    """Nested dicts and lists of tensors -> the same nesting of numpy
    arrays."""
    return tree_map(_leaf_to_numpy, tree)
