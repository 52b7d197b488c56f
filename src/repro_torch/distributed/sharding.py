"""Sharding policy: how every (arch x shape x mesh x mode) cell is
partitioned, the reference's ``distributed/sharding.py``, and the
collectives that run a model across the ranks of a mesh.

Axes: ``model`` hosts TP for dense ops and EP for experts; the data axes
(``data``, plus ``pod`` on the multi-pod mesh) host DP-engine replicas of
attention/dense compute, FSDP parameter sharding in training, and, for
single-request long-context decode, split-K KV sharding.

``make_policy``, ``make_param_specs``, ``batch_specs`` and
``cache_specs_tree`` follow the reference's rules leaf for leaf; a spec is
a :class:`PartitionSpec`, a tuple of one entry per dimension (an axis name,
a tuple of names, or ``None``), compared by value. A spec that does not
divide a dimension leaves it whole.

The reference only declares layouts and lets GSPMD insert the collectives.
Eager PyTorch has none, so here each rank holds exactly the shard its spec
names (:func:`shard_params`, :func:`local_zeros`) and the model code calls
the collectives of this module by hand (``all_reduce``, ``all_gather`` over
one or more mesh axes). The reference's method names stay
(``shard_resid``, ``shard_heads``, ``shard_kv_cache``, ...): each gives the
local shape of a tensor of the given global shape under its spec.

The port adds one field, ``cache_len``: the slot count of the dense cache
of the cell (``shape.seq_len``), the one global fact that a rank holding
only a slice of the ring cannot see in its shard.
"""
from __future__ import annotations

import dataclasses
from math import prod
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


class PartitionSpec(tuple):
    """One entry per dimension: an axis name, a tuple of axis names, or
    ``None``. A one-name tuple is kept as the name, as ``jax``'s
    ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    batch_axes: Tuple[str, ...]        # activation batch-dim axes
    fsdp_axes: Tuple[str, ...]         # param sharding over data axes (train)
    model_axis: str = "model"
    expert_data_shard: bool = False    # shard expert FFN dim over data axes
    expert_rowparallel: bool = True    # (the reference's layout knob)
    kv_split: int = 1                  # split-K decode shards
    kv_split_axes: Tuple[str, ...] = ()
    cache_len: int = 0                 # the cell's dense-cache slots

    # ---- sizes and this rank's place ---------------------------------
    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis]

    @property
    def world_size(self) -> int:
        return prod(self.mesh.shape.values())

    def size(self, axes) -> int:
        return prod(self.mesh.shape[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's block along a dimension sharded over ``axes``."""
        axes = _axes(axes)
        return self.mesh.index(axes) if self.size(axes) > 1 else 0

    def splits(self, dim: int, axes) -> bool:
        """Whether a dimension of global size ``dim`` sharded over ``axes``
        is cut into more than one block (the spec keeps only the axes that
        divide it)."""
        n = self.size(axes)
        return n > 1 and dim % n == 0

    @property
    def eds_axes(self) -> Tuple[str, ...]:
        """The axes of the expert FFN dimension under
        ``expert_data_shard`` (the reference's ``_param_rule``)."""
        if not self.expert_data_shard:
            return ()
        return self.fsdp_axes or ("data",)

    # ---- specs --------------------------------------------------------
    def cs(self, shape, *spec) -> PartitionSpec:
        """The spec with every entry that does not divide its dimension
        dropped (the reference's ``cs`` without the constraint)."""
        clean = []
        for dim, s in zip(shape, spec):
            ok = s is not None and dim % self.size(s) == 0
            clean.append(s if ok else None)
        return P(*clean)

    def local_shape(self, shape, spec) -> Tuple[int, ...]:
        return tuple(d // self.size(s) for d, s in
                     zip(shape, tuple(spec) + (None,) * len(shape)))

    def shard_resid(self, shape):
        if len(shape) == 3:      # (B, S, D)
            return self.local_shape(shape, self.cs(
                shape, self.batch_axes or None, None, None))
        return tuple(shape)

    def shard_heads(self, shape):
        # (B, S, H, hd): TP over heads when divisible
        return self.local_shape(shape, self.cs(
            shape, self.batch_axes or None, None, self.model_axis, None))

    def shard_ffn_act(self, shape):
        if len(shape) == 3:      # (B, S, F)
            return self.local_shape(shape, self.cs(
                shape, self.batch_axes or None, None, self.model_axis))
        if len(shape) == 2:      # (T, F)
            return self.local_shape(shape, self.cs(
                shape, self.batch_axes or None, self.model_axis))
        return tuple(shape)

    def shard_expert_act(self, shape):
        # (E, C, D): experts over the EP (model) axis
        return self.local_shape(shape, self.cs(shape, self.model_axis, None,
                                               None))

    def shard_expert_ffn(self, shape):
        # (E, C, F): F also over the data axes under expert_data_shard
        if self.expert_data_shard and self.expert_rowparallel:
            return self.local_shape(shape, self.cs(
                shape, self.model_axis, None, self.fsdp_axes or ("data",)))
        return self.shard_expert_act(shape)

    def shard_kv_cache(self, shape):
        # (B, L, Hkv, hd) (superblock slice)
        if self.kv_split > 1 and shape[1] % self.kv_split == 0:
            return self.local_shape(shape, self.cs(
                shape, self.batch_axes or None, self.kv_split_axes, None,
                None))
        return self.local_shape(shape, self.cs(
            shape, self.batch_axes or None, None, None, None))

    def shard_kv_scale(self, shape):
        # (B, L, Hkv) int8-KV scale array
        return self.shard_kv_cache(tuple(shape) + (1,))[:3]

    # ---- collectives ---------------------------------------------------
    def _stage(self, t):
        """(the buffer a collective runs on, the map of its result back).
        gloo takes CPU tensors: a CUDA tensor goes through a host copy (the
        compute stays on the card), bf16 and f16 as f32 (exact both ways).
        Otherwise a private copy, since the collective writes in place."""
        if getattr(self.mesh, "backend", None) != "gloo":
            return t.contiguous().clone(), (lambda r: r)
        dev, dt = t.device, t.dtype
        wide = torch.float32 if dt in (torch.bfloat16, torch.float16) else dt
        return t.to("cpu", wide, copy=True), (lambda r: r.to(dev, dt))

    def all_reduce(self, t, axes):
        """The sum of ``t`` over the ranks of ``axes`` (a new tensor; ``t``
        itself when ``axes`` span one rank)."""
        axes = _axes(axes)
        if self.size(axes) == 1:
            return t
        import torch.distributed as dist
        with torch.profiler.record_function("collective:all_reduce"):
            buf, back = self._stage(t)
            dist.all_reduce(buf, group=self.mesh.group(axes))
            return back(buf)

    def all_gather(self, t, axes, dim: int):
        """The blocks of ``t`` from the ranks of ``axes``, concatenated
        along ``dim`` in their order (the first axis major)."""
        axes = _axes(axes)
        n = self.size(axes)
        if n == 1:
            return t
        import torch.distributed as dist
        with torch.profiler.record_function("collective:all_gather"):
            buf, back = self._stage(t)
            parts = [torch.empty_like(buf) for _ in range(n)]
            dist.all_gather(parts, buf, group=self.mesh.group(axes))
            return back(torch.cat(parts, dim=dim))

    def take_block(self, t, axes, dim: int):
        """This rank's block of ``t`` along ``dim`` sharded over ``axes``."""
        n = self.size(axes)
        if n == 1:
            return t
        k = t.shape[dim] // n
        return t.narrow(dim, self.index(axes) * k, k)


def require_one_rank(policy, what: str) -> None:
    """Raise where a policy over several ranks reaches an entry point that
    does not honour it yet (ROADMAP.md Queue A item 11b): running it
    unsharded would be another program, not a fallback."""
    if policy is not None and policy.world_size > 1:
        raise NotImplementedError(
            f"{what} under a policy over {policy.world_size} ranks is "
            f"ROADMAP Queue A item 11b")


def _divides(b: int, sizes) -> bool:
    return b % prod(sizes) == 0 and b >= prod(sizes)


def make_policy(cfg: ModelConfig, shape: Optional[ShapeConfig], mesh,
                mode: str) -> ShardingPolicy:
    """mode: 'train' | 'serve'. The reference's rules; ``cache_len`` is
    ``shape.seq_len`` for decode and prefill cells."""
    axes = tuple(mesh.axis_names)
    data_axes = tuple(a for a in axes if a != "model")
    msz = mesh.shape["model"]

    B = shape.global_batch if shape is not None else 0
    # longest suffix of data axes whose product divides B
    batch_axes: Tuple[str, ...] = ()
    for i in range(len(data_axes)):
        cand = data_axes[i:]
        if _divides(B, [mesh.shape[a] for a in cand]):
            batch_axes = cand
            break

    fsdp_axes = data_axes if mode == "train" else ()

    # serving: shard expert FFN dim over data axes when the model-axis-only
    # footprint would blow the 16 GB/chip HBM budget (llama4-400b)
    param_bytes = cfg.param_count() * 2  # bf16
    expert_data_shard = (mode == "serve" and cfg.moe.enabled
                         and param_bytes / msz > 8e9) or \
                        (mode == "train" and cfg.moe.enabled)

    # KV caches split their sequence dim over the model axis (split-K flash
    # decode / sharded prefill cache); with no batch parallelism (B=1
    # long-context) the data axes join the split too.
    kv_split, kv_axes, cache_len = 1, (), 0
    if shape is not None and shape.kind in ("decode", "prefill"):
        kv_axes = ("model",) if batch_axes else data_axes + ("model",)
        kv_split = prod(mesh.shape[a] for a in kv_axes)
        cache_len = shape.seq_len

    return ShardingPolicy(
        mesh=mesh, batch_axes=batch_axes, fsdp_axes=fsdp_axes,
        expert_data_shard=expert_data_shard, kv_split=kv_split,
        kv_split_axes=kv_axes, cache_len=cache_len)


# ---------------------------------------------------------------- trees
def _key_name(k) -> str:
    return k if isinstance(k, str) else f"[{k}]"


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nesting of dicts, lists and tuples; a path
    is the tuple of dict keys (and ``"[i]"`` for list positions)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (_key_name(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (_key_name(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return fn(path, tree)


# ---------------------------------------------------------------- params
# rules: leaf-name -> (base_ndim, spec builder). Specs cover the LAST k dims;
# extra leading (stacked) dims are padded with None.
def _param_rule(name: str, path_names, cfg: ModelConfig,
                pol: ShardingPolicy):
    fsdp = pol.fsdp_axes or None
    M = pol.model_axis
    eds = pol.fsdp_axes if (pol.expert_data_shard and pol.fsdp_axes) else \
        (("data",) if pol.expert_data_shard else None)
    in_moe = "moe" in path_names
    if name == "embedding":
        return 2, (M, fsdp)
    if name == "lm_head":
        return 2, (fsdp, M)
    if name == "router":
        return 2, (fsdp, None)
    if in_moe and name in ("w_gate", "w_up"):
        return 3, (M, None, eds)
    if in_moe and name == "w_down":
        return 3, (M, eds, None)
    if name in ("w_gate", "w_up", "w_in", "wq", "wk", "wv", "in_proj",
                "w_u", "w_q", "w_k", "w_bc", "w_dt", "enc_in"):
        return 2, (fsdp, M)
    if name in ("w_down", "wo", "w_o", "out_proj"):
        return 2, (M, fsdp)
    if name in ("bq", "bk", "bv"):
        return 1, (M,)
    if name == "conv":
        return 2, (None, M)
    if name == "a_log":
        return 2, (M, None)
    return None  # replicate


def make_param_specs(abstract_params, cfg: ModelConfig, pol: ShardingPolicy):
    """PartitionSpec tree matching the params tree (tensors, or ``meta``
    tensors from ``models/api.param_specs_abstract``)."""
    def visit(path, leaf):
        name = path[-1] if path else ""
        rule = _param_rule(name, path, cfg, pol)
        nd = len(leaf.shape)
        if rule is None:
            return P()
        base_nd, spec = rule
        if nd < base_nd:
            return P()
        full = (None,) * (nd - base_nd) + tuple(spec)
        return pol.cs(leaf.shape, *full)

    return tree_map_with_path(visit, abstract_params)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, pol: ShardingPolicy,
                batch_tree):
    """PartitionSpec tree for a batch/tokens/lengths tree."""
    ba = pol.batch_axes or None

    def visit(path, leaf):
        if len(leaf.shape) == 0:
            return P()
        spec = [ba] + [None] * (len(leaf.shape) - 1)
        if ba is not None and leaf.shape[0] % pol.size(ba):
            spec[0] = None
        return P(*spec)

    return tree_map_with_path(visit, batch_tree)


def cache_specs_tree(cfg: ModelConfig, pol: ShardingPolicy, cache_tree):
    """Specs for KV/state caches: (ns, B, L, H, hd) + mamba/encdec
    layouts."""
    ba = pol.batch_axes or None

    def visit(path, leaf):
        name = path[-1] if path else ""
        shp = tuple(leaf.shape)
        nd = len(shp)
        if name in ("k", "v", "xk", "xv") and nd == 5:
            b_ok = _cache_b_ok(shp, 1, ba, pol)
            l_ok = pol.kv_split > 1 and shp[2] % pol.kv_split == 0
            return P(None, ba if b_ok else None,
                     pol.kv_split_axes if l_ok else None, None, None)
        if name in ("k_scale", "v_scale") and nd == 4:
            b_ok = _cache_b_ok(shp, 1, ba, pol)
            l_ok = pol.kv_split > 1 and shp[2] % pol.kv_split == 0
            return P(None, ba if b_ok else None,
                     pol.kv_split_axes if l_ok else None, None)
        if name == "mamba_h" and nd == 4:    # (ns, B, d_in, N)
            return P(None, ba, pol.model_axis, None) \
                if _cache_b_ok(shp, 1, ba, pol) else \
                P(None, None, pol.model_axis, None)
        if name == "mamba_conv" and nd == 4:  # (ns, B, w-1, d_in)
            return P(None, ba, None, pol.model_axis) \
                if _cache_b_ok(shp, 1, ba, pol) else \
                P(None, None, None, pol.model_axis)
        if name in ("C",) and nd == 4:        # mLSTM (B, H, hd, hd)
            return P(ba if _cache_b_ok(shp, 0, ba, pol) else None,
                     None, None, None)
        if nd >= 1 and ba is not None and _cache_b_ok(shp, 0, ba, pol):
            return P(*([ba] + [None] * (nd - 1)))
        return P(*([None] * nd))

    return tree_map_with_path(visit, cache_tree)


def _cache_b_ok(shape, b_dim, ba, pol) -> bool:
    if ba is None:
        return False
    size = pol.size(ba)
    return shape[b_dim] % size == 0 and shape[b_dim] >= size


# ---------------------------------------------------------------- shards
def _zip_trees(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_trees(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_trees(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def local_block(t: torch.Tensor, spec, pol: ShardingPolicy) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` (a
    view)."""
    for d, s in enumerate(spec):
        if s is not None:
            t = pol.take_block(t, s, d)
    return t


def shard_params(params, specs, pol: ShardingPolicy, device=None):
    """Each leaf's block for this rank under its spec, as a contiguous copy
    on ``device`` (default: the leaf's own), so the global tree can be
    freed. Carries weights across: JAX params -> ``bridge.params_from_numpy``
    -> ``shard_params``."""
    return _zip_trees(
        lambda t, s: local_block(t, s, pol).to(
            device if device is not None else t.device,
            copy=True).contiguous(), params, specs)


def local_zeros(abstract, specs, pol: ShardingPolicy, device):
    """Zeros of each leaf's local shape and dtype (``abstract``: a tree of
    tensors of the global shapes, e.g. on the ``meta`` device): a rank's
    shard of a fresh cache without the global one."""
    return _zip_trees(
        lambda t, s: torch.zeros(pol.local_shape(t.shape, s), dtype=t.dtype,
                                 device=device), abstract, specs)


def spec_bytes(abstract, specs, pol: ShardingPolicy) -> int:
    """The bytes one rank holds of ``abstract`` under ``specs``."""
    total = [0]

    def add(t, s):
        total[0] += prod(pol.local_shape(t.shape, s)) * t.element_size()

    _zip_trees(add, abstract, specs)
    return total[0]
