"""AdamW with configurable moment dtype (fp32 / bf16 / int8-blockwise).

The reference's ``train/optimizer.py``: the same configuration, state
layout (``OptState`` fields in the same order, one moment leaf per param
leaf, so checkpoints cross between the packages) and arithmetic. The int8
moments are quantized per block of ``block`` elements of the flattened
leaf; the second moment is stored in the sqrt domain and rounded up
(``_quant_ceil``), so a nonzero entry never collapses to 0.

Every leaf is updated in slices of its flattened elements (a multiple of
``block``, so each int8 block lies whole in one slice and its codes are
those of a whole-leaf pass): at full width one stacked expert leaf holds
1.6 billion elements, and its f32 gradient, moments and update at once
would take tens of GB. ``apply_updates`` leaves ``params`` and ``state``
as they are; it consumes ``grads``, whose leaves may receive the new
params.

Under a policy over several ranks each rank holds its blocks of the params
and grads, laid out by the policy's spec tree (``sharding.leaf_specs``).
The global norm sums
each leaf's squares over the axes the leaf is cut on, counting a
replicated leaf once; fp32 and bf16 moments are cut like their params and
updated elementwise; int8 moments are replicated, as the reference's train
cell lays them out (``launch/cells.py``: ``P()`` for ``mu``/``nu`` when
``moment_dtype == "int8"``), so their 128-element blocks are those of the
whole leaf: a cut leaf's grad and params are gathered, the whole leaf is
updated, and each rank keeps its block of the new params.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.bridge import tree_flatten, tree_map, tree_unflatten
from repro_torch.distributed.sharding import (gather_global, global_shape,
                                               leaf_specs, local_block,
                                               spec_axes)

# elements of one leaf updated at once (64 MiB of f32 per transient)
SLICE_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "bfloat16"   # float32 | bfloat16 | int8
    block: int = 128                 # int8 blockwise-scaling block


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any
    mu_scale: Any    # int8 mode only (per-block scales); else f32 zeros
    nu_scale: Any


def _quant(x, block):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    blk = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = blk.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blk / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale[:, 0].float()


def _quant_ceil(x, block):
    """Absmax int8 for non-negative values, rounding UP: a nonzero entry
    never quantizes to 0 (used for the sqrt second moment, where a collapse
    to 0 would turn the Adam denominator into bare eps and diverge)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    blk = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = blk.amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.ceil(blk / torch.clamp(scale, min=1e-12)), 0, 127) \
        .to(torch.int8)
    return q, scale[:, 0].float()


def _dequant(q, scale, shape, block):
    n = 1
    for s in shape:
        n *= s
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:n].reshape(shape)


def _torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_opt_state(params, cfg: AdamWConfig, *, policy=None) -> OptState:
    """Zero moments. Under a policy over several ranks int8 moments hold
    the whole leaf's blocks."""
    dev = next(iter(tree_flatten(params))).device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.moment_dtype == "int8":
        sizes = [t.numel() for t in tree_flatten(params)]
        s_leaves = leaf_specs(policy)
        if s_leaves is not None:
            sizes = [int(torch.Size(global_shape(t, s, policy)).numel())
                     for t, s in zip(tree_flatten(params), s_leaves)]
        leaves = tree_flatten(params)

        # the codes and scales of zeros: all zero
        def codes():
            return tree_unflatten(params, [
                torch.zeros((-(-n // cfg.block), cfg.block),
                            dtype=torch.int8, device=p.device)
                for n, p in zip(sizes, leaves)])

        def scales():
            return tree_unflatten(params, [
                torch.zeros(-(-n // cfg.block), dtype=torch.float32,
                            device=p.device) for n, p in zip(sizes, leaves)])

        return OptState(step, codes(), codes(), scales(), scales())
    dt = _torch_dtype(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    def z32(p):
        return torch.zeros((), dtype=torch.float32, device=p.device)

    return OptState(step, tree_map(zeros, params), tree_map(zeros, params),
                    tree_map(z32, params), tree_map(z32, params))


def _slices(n: int, size: int):
    for a in range(0, n, size):
        yield a, min(a + size, n)


def global_norm(tree, policy=None):
    """sqrt of the sum over leaves (in the reference's leaf order) of each
    leaf's f32 sum of squares, taken a slice at a time. Under a policy over
    several ranks each leaf's sum is summed over the axes its spec cuts
    (one all_reduce for the leaves cut on the same axes), so a replicated
    leaf counts once."""
    sums = []
    for g in tree_flatten(tree):
        flat = g.reshape(-1)
        sums.append(sum(flat[a:b].float().square().sum()
                        for a, b in _slices(flat.numel(), SLICE_ELEMS)))
    s_leaves = leaf_specs(policy)
    if s_leaves is None:
        total = None
        for sq in sums:
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    groups = {}
    for sq, s in zip(sums, s_leaves):
        axes = spec_axes(s, policy)
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = sum(policy.all_reduce(groups[axes], axes)
                for axes in sorted(groups))
    return torch.sqrt(total)


def _output_buffers(params, grads):
    """The buffer each leaf's new params go to: its grad where the grad
    owns its memory outright (contiguous, the param's dtype and shape, the
    whole of a storage no other grad or param shares), else a new
    tensor."""
    def key(t):
        return (t.device, t.untyped_storage().data_ptr())

    uses = {}
    for t in grads + params:
        uses[key(t)] = uses.get(key(t), 0) + 1
    out = []
    for p, g in zip(params, grads):
        own = (g.dtype == p.dtype and g.shape == p.shape
               and g.is_contiguous() and uses[key(g)] == 1
               and g.untyped_storage().nbytes() == g.numel()
               * g.element_size())
        out.append(g if own else torch.empty_like(p))
    return out


def apply_updates(params, grads, state: OptState, cfg: AdamWConfig, *,
                  policy=None):
    """One AdamW step -> (new params, new OptState). ``params`` and
    ``state`` are left as they are (the caller may still hold them);
    ``grads`` is consumed: a grad leaf that owns its memory receives its
    leaf's new params. The gradient is clipped by the global norm, the
    bias corrections are ``1 - b ** step`` in f32. ``policy``: the blocks
    of a policy over several ranks (see the module)."""
    step = state.step + 1
    p_leaves = tree_flatten(params)
    g_leaves = tree_flatten(grads)
    s_leaves = leaf_specs(policy) or [None] * len(p_leaves)
    clip = None
    if cfg.grad_clip > 0:
        gn = global_norm(grads, policy)
        clip = torch.clamp(torch.full_like(gn, cfg.grad_clip)
                           / torch.clamp(gn, min=1e-9), max=1.0)
    stepf = step.float()
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32,
                             device=stepf.device) ** stepf
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32,
                             device=stepf.device) ** stepf
    outs = _output_buffers(p_leaves, g_leaves)
    int8 = cfg.moment_dtype == "int8"
    mu, nu = tree_flatten(state.mu), tree_flatten(state.nu)
    if int8:
        ms, vs = tree_flatten(state.mu_scale), tree_flatten(state.nu_scale)
        new = [[torch.empty_like(t) for t in leaves]
               for leaves in (mu, nu, ms, vs)]
    else:
        new = [[torch.empty_like(t) for t in leaves] for leaves in (mu, nu)]
    size = max(cfg.block, SLICE_ELEMS // cfg.block * cfg.block)
    for i, (p, g, out) in enumerate(zip(p_leaves, g_leaves, outs)):
        spec = s_leaves[i]
        whole = int8 and spec is not None and \
            policy.size(spec_axes(spec)) > 1
        if whole:             # replicated int8 moments: the whole leaf
            p = gather_global(p, spec, policy)
            g = gather_global(g, spec, policy)
            block_out, out = out, torch.empty_like(p)
        pf, gf, of = p.reshape(-1), g.reshape(-1), out.view(-1)
        for a, b in _slices(pf.numel(), size):
            g32 = gf[a:b].float()
            if clip is not None:
                g32 = g32 * clip
            p32 = pf[a:b].float()
            if int8:
                k0, k1 = a // cfg.block, -(-b // cfg.block)
                m = _dequant(mu[i][k0:k1], ms[i][k0:k1], (b - a,), cfg.block)
                # the second moment is stored int8 in the SQRT domain
                r = _dequant(nu[i][k0:k1], vs[i][k0:k1], (b - a,), cfg.block)
                v = torch.square(r)
            else:
                m = mu[i].view(-1)[a:b].float()
                v = nu[i].view(-1)[a:b].float()
            m32 = cfg.b1 * m + (1 - cfg.b1) * g32
            v32 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
            u = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
            u = u + cfg.weight_decay * p32
            of[a:b] = (p32 - cfg.lr * u).to(p.dtype)
            if int8:
                mq, msc = _quant(m32, cfg.block)
                vq, vsc = _quant_ceil(torch.sqrt(v32), cfg.block)
                new[0][i][k0:k1], new[2][i][k0:k1] = mq, msc
                new[1][i][k0:k1], new[3][i][k0:k1] = vq, vsc
            else:
                new[0][i].view(-1)[a:b] = m32
                new[1][i].view(-1)[a:b] = v32
        if whole:
            block_out.copy_(local_block(out, spec, policy))
    new_params = tree_unflatten(params, outs)
    if int8:
        nmu, nnu, nms, nvs = (tree_unflatten(t, leaves) for t, leaves in zip(
            (state.mu, state.nu, state.mu_scale, state.nu_scale), new))
        return new_params, OptState(step, nmu, nnu, nms, nvs)
    return new_params, OptState(step, tree_unflatten(state.mu, new[0]),
                                tree_unflatten(state.nu, new[1]),
                                state.mu_scale, state.nu_scale)
