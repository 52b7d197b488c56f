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

The port adds two fields: ``cache_len``, the slot count of the dense cache
of the cell (``shape.seq_len``), the one global fact that a rank holding
only a slice of the ring cannot see in its shard; and ``cfg``, the config
the policy was made for, from which :func:`param_specs` gives the params'
spec tree to the models, the optimizer and the train step alike (a rank's
block carries no layout).
"""
from __future__ import annotations

import dataclasses
import functools
from math import prod
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch import counting


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
    cfg: Any = dataclasses.field(default=None, repr=False)

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
    # Each collective is a ``torch.autograd.Function`` whose backward is the
    # one its consumers call for (the usual tensor-parallel pairs): after
    # the forward, a tensor that is the same on every rank of an axis
    # carries its whole gradient on each of them, and a tensor that differs
    # (a block, a partial sum, other rows) the gradient of its own part.
    # Every sum runs in f32 (gloo: through a host copy).
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

    def _reduce(self, t, axes, op: str = "sum"):
        """The elementwise ``op`` of ``t`` over the ranks of ``axes``, no
        autograd (a new tensor; ``t`` itself over one rank)."""
        axes = _axes(axes)
        if self.size(axes) == 1:
            return t
        import torch.distributed as dist
        with counting.span("collective:all_reduce"), \
                counting.record("all-reduce", t):
            buf, back = self._stage(t)
            dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                     "max": dist.ReduceOp.MAX}[op],
                            group=self.mesh.group(axes))
            return back(buf)

    def _gather(self, t, axes, dim: int):
        axes = _axes(axes)
        n = self.size(axes)
        if n == 1:
            return t
        import torch.distributed as dist
        with counting.span("collective:all_gather"), \
                counting.record("all-gather", t, n):
            buf, back = self._stage(t)
            parts = [torch.empty_like(buf) for _ in range(n)]
            dist.all_gather(parts, buf, group=self.mesh.group(axes))
            return back(torch.cat(parts, dim=dim))

    def _sum32(self, g, axes):
        axes = _axes(axes)
        if self.size(axes) == 1:
            return g
        return self._reduce(g.float(), axes).to(g.dtype)

    def all_reduce(self, t, axes, op: str = "sum"):
        """The sum of ``t`` over the ranks of ``axes`` (``op="max"``: the
        largest, no gradient): the sum of partial results (a row-parallel
        product's, the statistics'). Backward: the identity, since the
        ranks of ``axes`` consume the same sum."""
        if op != "sum" or not _grad(t):
            return self._reduce(t, axes, op)
        return _AllReduce.apply(t, self, _axes(axes))

    def all_gather(self, t, axes, dim: int, sum_axes=()):
        """The blocks of ``t`` from the ranks of ``axes``, concatenated
        along ``dim`` in their order (the first axis major). Backward: the
        gradient summed over ``sum_axes`` (the axes whose ranks consume the
        gathered tensor differently: other heads, other experts, other FFN
        blocks), then this rank's block."""
        if not _grad(t):
            return self._gather(t, axes, dim)
        return _AllGather.apply(t, self, _axes(axes), dim, _axes(sum_axes))

    def enter(self, t, axes):
        """The identity, whose backward sums the gradient over ``axes``:
        where a tensor that is the same on the ranks of ``axes`` is
        consumed differently by each (the entry of a column-parallel
        product, heads or channels of their own)."""
        if not _grad(t) or self.size(axes) == 1:
            return t
        return _Enter.apply(t, self, _axes(axes))

    def split(self, t, axes, dim: int):
        """This rank's block of ``t``, a tensor that is the same on the
        ranks of ``axes``, whose backward gathers the blocks' gradients."""
        if not _grad(t):
            return self.take_block(t, axes, dim)
        return _Split.apply(t, self, _axes(axes), dim)

    def gather_blocks(self, t, axes, sum_axes=()):
        """The blocks of ``t`` from the ranks of ``axes``, in their order
        (the first axis major), as a tuple along dim 0 (views of one
        all_gather). Backward: each block's gradient summed over
        ``sum_axes`` in f32, and this rank's kept, one block at a time, so
        the f32 sum of all the blocks' gradients at once, which
        ``all_gather(sum_axes=)``'s backward makes, never exists. Over one
        rank ``(enter(t, sum_axes),)``."""
        if self.size(axes) == 1:
            return (self.enter(t, sum_axes),)
        if not _grad(t):
            return tuple(self._gather(t, axes, 0).split(t.shape[0]))
        return _GatherBlocks.apply(t, self, _axes(axes), _axes(sum_axes))

    def keep_own(self, kept, y, mine: bool, axes):
        """One link of the chain that keeps this rank's block of a tensor
        made block by block, block c held by rank c of ``axes`` (a sum over
        the gathered blocks of :meth:`gather_blocks`, say): ``y`` where it
        is this rank's block (``mine``), else ``kept``, the chain so far
        (None before the first block). Backward: ``y`` gets its owner's
        gradient, summed over ``axes`` from the owner's and the other
        ranks' zeros (what ``split``'s backward gathers for all the blocks
        at once). Over one rank ``y``."""
        if self.size(axes) == 1:
            return y
        if not _grad(y):
            return y if mine else kept
        return _KeepOwn.apply(kept, y, mine, self, _axes(axes))

    def take_block(self, t, axes, dim: int):
        """This rank's block of ``t`` along ``dim`` sharded over ``axes``."""
        n = self.size(axes)
        if n == 1:
            return t
        k = t.shape[dim] // n
        return t.narrow(dim, self.index(axes) * k, k)


def _grad(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pol, axes):
        return pol._reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pol, axes):
        ctx.pol, ctx.axes = pol, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.pol._sum32(g, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pol, axes, dim, sum_axes):
        ctx.pol, ctx.axes, ctx.dim, ctx.sum_axes = pol, axes, dim, sum_axes
        out = pol._gather(t, axes, dim)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        pol = ctx.pol
        g = pol._sum32(g, ctx.sum_axes)
        return pol.take_block(g, ctx.axes, ctx.dim).contiguous(), None, \
            None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pol, axes, dim):
        ctx.pol, ctx.axes, ctx.dim = pol, axes, dim
        return pol.take_block(t, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.pol._gather(g.contiguous(), ctx.axes, ctx.dim), None, \
            None, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pol, axes, sum_axes):
        ctx.pol, ctx.axes, ctx.sum_axes = pol, axes, sum_axes
        ctx.like = (t.shape, t.dtype, t.device)
        return tuple(pol._gather(t, axes, 0).split(t.shape[0]))

    @staticmethod
    def backward(ctx, *gs):
        pol = ctx.pol
        shape, dtype, device = ctx.like
        out = None
        for c, g in enumerate(gs):
            if g is None:
                g = torch.zeros(shape, dtype=dtype, device=device)
            g = pol._sum32(g.contiguous(), ctx.sum_axes)
            if c == pol.index(ctx.axes):
                out = g
        return out, None, None, None


class _KeepOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kept, y, mine, pol, axes):
        ctx.mine, ctx.pol, ctx.axes = mine, pol, axes
        ctx.first = kept is None
        if mine:
            return y.view_as(y)
        return torch.zeros_like(y) if kept is None else kept.view_as(kept)

    @staticmethod
    def backward(ctx, g):
        gy = ctx.pol._reduce(g if ctx.mine else torch.zeros_like(g),
                             ctx.axes)
        gk = None if ctx.first else (torch.zeros_like(g) if ctx.mine
                                     else g)
        return gk, gy, None, None, None


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
        kv_split_axes=kv_axes, cache_len=cache_len, cfg=cfg)


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


# ---------------------------------------------------------------- training
# Under a train policy each rank holds its spec's block of every param;
# the model gathers a block's FSDP dimensions just before the block runs
# (inside its ``torch.utils.checkpoint`` region, so the recompute gathers
# again), and the gathers' backward sums the gradient over the batch axes
# and keeps this rank's block: a reduce-scatter. A leaf that the spec
# leaves whole over a batch axis gets its gradient summed over that axis
# (:func:`grad_entry`), the all-reduce that XLA inserts for the reference.
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")    # also what a migration moves


def map_specs(fn, specs, path=()):
    """``fn(path, spec)`` over a spec tree (dicts and lists of
    :class:`PartitionSpec`), paths as :func:`tree_map_with_path` gives
    them."""
    if isinstance(specs, PartitionSpec):
        return fn(path, specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, path + (_key_name(k),))
                for k, v in specs.items()}
    return [map_specs(fn, v, path + (_key_name(i),))
            for i, v in enumerate(specs)]


def spec_axes(spec, pol: Optional[ShardingPolicy] = None
              ) -> Tuple[str, ...]:
    """Every mesh axis a spec cuts over: in dimension order, or in the
    mesh's order given ``pol`` (the order of the process groups that a
    reduction over all of them runs on)."""
    axes = tuple(a for s in spec for a in _axes(s))
    if pol is None:
        return axes
    return tuple(a for a in pol.mesh.axis_names if a in axes)


def param_specs(cfg: Optional[ModelConfig], pol: ShardingPolicy):
    """The spec tree of ``cfg``'s params under ``pol`` (``cfg`` None: the
    config the policy was made for), from the abstract params
    (``models/api.param_specs_abstract``: global shapes on the ``meta``
    device), which a rank's shards cannot show. Cached: the entry points
    ask for it on every call; callers do not modify it."""
    cfg = pol.cfg if cfg is None else cfg
    if cfg is None:
        raise ValueError("param_specs: the policy names no config; make "
                         "it with make_policy")
    if pol.cfg is not None and pol.cfg is not cfg and pol.cfg != cfg:
        raise ValueError("param_specs: the policy was made for another "
                         "config")
    return _param_specs(cfg, pol)


@functools.lru_cache(maxsize=32)
def _param_specs(cfg: ModelConfig, pol: ShardingPolicy):
    from repro_torch.models.api import param_specs_abstract
    return make_param_specs(param_specs_abstract(cfg), cfg, pol)


def leaf_specs(pol: Optional[ShardingPolicy]):
    """The specs of the params of the config ``pol`` was made for
    (:func:`param_specs`), in their leaf order, under a policy over several
    ranks; None without one or over one rank."""
    if pol is None or pol.world_size == 1:
        return None
    return flatten_specs(param_specs(None, pol))


def fsdp_plan(specs, pol: ShardingPolicy, everything: bool = False):
    """Per leaf, the part of its spec that the model gathers before use:
    the dimensions cut over the FSDP axes only (``everything``: every cut
    dimension, the world-1 blocks of xLSTM), except an expert leaf's FFN
    dimension, which the MoE layer keeps cut (``expert_data_shard``)."""
    fsdp = set(pol.fsdp_axes)

    def visit(path, s):
        if not everything and "moe" in path and path[-1] in EXPERT_LEAVES:
            return P(*([None] * len(s)))
        return P(*(e if e is not None and (everything or set(_axes(e))
                                           <= fsdp) else None for e in s))

    return map_specs(visit, specs)


def drop_leading(specs):
    """The specs of one layer of ``(n, ...)``-stacked leaves."""
    return map_specs(lambda _, s: P(*tuple(s)[1:]), specs)


def gather_leaves(tree, plan, pol: ShardingPolicy, promote=None):
    """Each leaf gathered along the dimensions its ``plan`` entry names
    (:func:`fsdp_plan`); a leaf that is None (a layer another rank holds)
    stays None. Backward: summed over the batch axes among those the
    dimension was cut on, then this rank's block. ``promote``: a dtype each
    gathered leaf is first cast up to (``torch.promote_types``), for a
    block that computes in the promoted type of its weights and
    activations: its ranks' partial gradients are then summed before the
    one rounding to the leaf's dtype, as on one rank."""
    ba = set(pol.batch_axes)

    def gather(t, s):
        if t is None:
            return None
        if promote is not None and any(e is not None for e in s):
            t = t.to(torch.promote_types(t.dtype, promote))
        for d, e in enumerate(s):
            if e is not None and pol.size(e) > 1:
                t = pol.all_gather(t, e, d, sum_axes=tuple(
                    a for a in _axes(e) if a in ba))
        return t

    return _zip_trees(gather, tree, plan)


def grad_entry(tree, specs, pol: ShardingPolicy):
    """Each leaf through :meth:`ShardingPolicy.enter` over the batch axes
    its spec leaves whole: the forward is the identity, and the backward
    sums the leaf's gradient over those axes, in f32."""
    def visit(t, s):
        axes = tuple(a for a in pol.batch_axes if a not in spec_axes(s))
        return pol.enter(t, axes) if axes else t

    return _zip_trees(visit, tree, specs)


def gather_global(t: torch.Tensor, spec, pol: ShardingPolicy):
    """The global tensor from every rank's block under ``spec`` (no
    autograd); ``t`` itself where the spec cuts nothing."""
    for d, e in enumerate(spec):
        if e is not None:
            t = pol._gather(t.contiguous(), e, d)
    return t


def flatten_specs(specs) -> list:
    """The specs of a tree in ``bridge.tree_flatten``'s leaf order (dict
    keys sorted, lists and NamedTuple fields in order), a
    :class:`PartitionSpec` a leaf."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in flatten_specs(specs[k])]
    return [x for v in specs for x in flatten_specs(v)]


def global_shape(t, spec, pol: ShardingPolicy) -> Tuple[int, ...]:
    """The global shape of a rank's block ``t`` under ``spec``."""
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    return tuple(d * pol.size(s) for d, s in zip(t.shape, spec))
