"""Mixture-of-Experts layer with placement-aware dispatch + Gimbal statistics.

* Expert weights are stored in **physical slot order**; the Gimbal expert
  placement is a logical->physical permutation passed as a runtime input
  (``placement``), so migrating experts moves weight rows, in place.
* Two dispatch formulations: the sort-based dropless ragged path
  (``kernels/moe_dispatch.py`` + the ragged GMM kernel, the default) and
  the capacity-padded path (``ragged=False``: per-row expert queues of
  capacity C, drops past C, the batched ``moe_gmm`` kernel).
* The layer emits the paper's two statistics along the dispatch path:
  aggregate expert load ``B[e]`` and the source-DP-to-expert matrix
  ``A[s, e]`` (logical expert ids), the latter from the
  ``source_expert_count`` kernel on the router's ids.
* Under a policy over several ranks (``distributed/sharding.py``) the
  experts are split over ``model`` (EP) and, under ``expert_data_shard``
  (always in training), their FFN dimension over the data axes; each rank
  runs the slots routed to its own experts through the same kernels, and
  the parts are summed (:func:`_sharded_moe_layer`). The collectives carry
  gradients, so both dispatch modes train under a policy.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import EXPERT_LEAVES
from repro_torch.kernels.moe_dispatch import (pick_row_block, ragged_combine,
                                              ragged_dispatch, ragged_gmm)
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.source_expert_count import source_expert_count
from repro_torch.models.layers import dense_init, init_mlp, mlp, torch_dtype




def init_moe(cfg, *, generator: torch.Generator, device="cuda"):
    m = cfg.moe
    d = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    kw = dict(generator=generator, device=device)
    p = {
        "router": dense_init((d, m.n_experts), 0, torch.float32, **kw),
        "w_gate": dense_init((m.n_experts, d, m.d_expert), 1, dt, **kw),
        "w_up": dense_init((m.n_experts, d, m.d_expert), 1, dt, **kw),
        "w_down": dense_init((m.n_experts, m.d_expert, d), 1, dt, **kw),
    }
    if m.n_shared_experts:
        # the always-on shared expert(s), one SwiGLU MLP (llama4)
        p["shared"] = init_mlp(d, m.n_shared_experts * m.d_shared, dt, **kw)
    return p


def route(params, cfg, x2d):
    """Router: x2d (..., D) -> (gates (..., K), ids (..., K), probs (..., E)).
    f32 softmax, top-k, gates renormalised over the k chosen."""
    logits = x2d.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    return gates, expert_idx.to(torch.int32), probs


def expert_statistics(expert_idx, n_experts: int, source_ids=None,
                      n_sources: int = 0, token_mask=None):
    """B[e] and A[s, e] by scatter-add (logical ids). expert_idx: (T, K).
    token_mask: tokens counted with weight 0 are excluded."""
    k = expert_idx.shape[-1]
    flat = expert_idx.reshape(-1).long()
    if token_mask is None:
        w = torch.ones_like(flat)
    else:
        w = torch.repeat_interleave(token_mask.reshape(-1).long(), k)
    counts = torch.zeros(n_experts, dtype=torch.long, device=flat.device)
    counts.index_add_(0, flat, w)
    stats = {"expert_counts": counts.to(torch.int32)}
    if source_ids is not None and n_sources > 0:
        src = torch.repeat_interleave(source_ids.reshape(-1).long(), k)
        a = torch.zeros(n_sources * n_experts, dtype=torch.long,
                        device=flat.device)
        a.index_add_(0, src * n_experts + flat, w)
        stats["source_expert"] = a.reshape(n_sources, n_experts) \
            .to(torch.int32)
    return stats


def _routing_stats(logical_idx, E, src2d, n_sources: int, token_mask,
                   kernel: bool, counts=None):
    """B[e] and A[s, e] (logical ids) of the routed tokens. B is ``counts``
    where given (the ragged dispatch's bincount, gathered by placement),
    else a masked scatter-add. A comes from the statistics kernel on the
    router's ids as they come (the counts do not depend on order) when
    ``kernel`` (the ragged path), else by scatter-add; a masked token's
    source is -1, which counts nowhere."""
    if not kernel:
        return expert_statistics(logical_idx, E, src2d, n_sources,
                                 token_mask=token_mask)
    K = logical_idx.shape[-1]
    T = logical_idx.numel() // K
    stats = {"expert_counts": counts} if counts is not None else \
        expert_statistics(logical_idx.reshape(T, K), E,
                          token_mask=token_mask)
    if src2d is not None and n_sources > 0:
        ss = src2d if token_mask is None else torch.where(
            token_mask.reshape(src2d.shape), src2d, -1)
        _, a = source_expert_count(
            logical_idx.reshape(T, K).to(torch.int32).contiguous(),
            ss.reshape(T).to(torch.int32).contiguous(), n_experts=E,
            n_sources=n_sources)
        stats["source_expert"] = a
    return stats


class _ZerosTied(torch.autograd.Function):
    """f32 zeros whose backward gives each input a zero gradient."""

    @staticmethod
    def forward(ctx, shape, *ts):
        ctx.like = [(t.shape, t.dtype, t.device) for t in ts]
        return torch.zeros(shape, dtype=torch.float32, device=ts[0].device)

    @staticmethod
    def backward(ctx, _):
        return (None, *(torch.zeros(s, dtype=d, device=v)
                        for s, d, v in ctx.like))


def zeros_tied(shape, *ts):
    """f32 zeros of ``shape``; under autograd, tied to ``ts`` (their
    gradient zero), so that a rank whose part is empty still runs the
    backward of the collectives that made ``ts``, as the other ranks do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _ZerosTied.apply(tuple(shape), *ts)
    return torch.zeros(shape, dtype=torch.float32, device=ts[0].device)


def _ragged_moe_ffn(params, x, gates, logical_idx, placement, E, K, src2d,
                    n_sources: int, collect_stats: bool, token_mask=None):
    """Sort-based dropless expert FFN: sort physical ids -> group sizes ->
    block-aligned gather -> ragged GMM (gate, up, down) -> gate-weighted
    combine. Issued FLOPs scale with the real tokens per expert. Returns
    (y (B, S, D) f32, statistics): :func:`_ragged_blocks` of one block.
    Under expert parallelism the layer goes through
    :func:`_sharded_moe_layer` instead."""
    sizes, parts = _ragged_blocks(params, (x,), (gates,), (logical_idx,),
                                  placement, E, K)
    stats = {}
    if collect_stats:
        # physical slot placement[l] holds logical expert l, so the logical
        # load B[e] is a gather of the sort pass's bincount; masked tokens
        # still dispatch but must not register load
        counts = sizes[placement.long()] if token_mask is None else None
        stats = _routing_stats(logical_idx, E, src2d, n_sources, token_mask,
                               True, counts)
    (y,) = parts
    return y, stats


def _cat(ts):
    return ts[0] if len(ts) == 1 else torch.cat(ts)


def _ragged_blocks(params, xs, gates, ids, placement, E, K, e0: int = 0):
    """The ragged expert FFN of the tokens of the blocks ``xs`` (each
    (Bc, S, D), one rank's tokens, with their ``gates`` and ``ids``) ->
    (the dispatch's group sizes, or None where no slot is routed here; an
    iterator of each block's f32 output (Bc, S, D) in turn). One dispatch
    and one launch of each GMM over all the blocks' slots routed to this
    rank's experts, as for the gathered tokens in one piece; the combine
    one block at a time, as the iterator is read, so no tensor the size of
    all the blocks' outputs is made. ``params`` hold the experts of
    physical slots [e0, e0 + E_loc)."""
    Bc, S, D = xs[0].shape
    Tc, n = Bc * S, len(xs)
    T = n * Tc
    E_loc = params["w_gate"].shape[0]
    phys = placement.long()[_cat(ids).long()].reshape(T, K)
    g = _cat(gates).reshape(T, K)
    if E_loc == E:                     # every expert here: as one call
        nb = pick_row_block(T * K, E)
        disp = ragged_dispatch(_cat(xs).reshape(T, D), phys, E,
                               row_block=nb)
    else:
        local = (phys >= e0) & (phys < e0 + E_loc)
        sel = torch.nonzero(local.reshape(-1)).flatten()
        if not sel.numel():            # no slot routed to these experts
            return None, (zeros_tied((Bc, S, D), xc, gc,
                                     *(params[k] for k in EXPERT_LEAVES))
                          for xc, gc in zip(xs, gates))
        # each block's bounds in sel (ascending flat (token, k) indices),
        # and the rows of its slots, read from the block itself
        cut = torch.searchsorted(sel, torch.arange(
            n + 1, device=sel.device) * Tc * K).tolist()
        tok = torch.div(sel, K, rounding_mode="floor")
        rows = torch.cat([xs[c].reshape(Tc, D)[tok[cut[c]:cut[c + 1]]
                                               - c * Tc] for c in range(n)])
        nb = pick_row_block(int(sel.numel()), E_loc)
        disp = ragged_dispatch(rows, (phys.reshape(-1)[sel] - e0)
                               .reshape(-1, 1), E_loc, row_block=nb)
    args = (disp.tile_expert, disp.group_sizes, disp.padded_offsets, nb)
    gate = ragged_gmm(disp.xs, params["w_gate"], *args)
    up = ragged_gmm(disp.xs, params["w_up"], *args)
    h = (F.silu(gate) * up).to(xs[0].dtype)   # f32 on the GMM's outputs
    ys = ragged_gmm(h, params["w_down"], *args)

    def combine(c):
        t0, t1 = c * Tc, (c + 1) * Tc
        if E_loc == E:
            y = ragged_combine(ys, disp.dest[t0 * K:t1 * K], g[t0:t1])
        else:
            lo, hi = cut[c], cut[c + 1]
            y = _local_combine(ys[disp.dest[lo:hi].long()],
                               sel[lo:hi] - t0 * K, g[t0:t1], Tc, K)
        return y.reshape(Bc, S, D)
    return disp.group_sizes, map(combine, range(n))


def _local_combine(ys, sel, g, T: int, K: int):
    """The gate-weighted sum of each token's slots routed to this rank's
    experts: ``ys`` (n, F) f32 the outputs of the local slots ``sel``
    (ascending flat (token, k) indices), ``g`` (T, K) -> (T, F). A token's
    slots are added in k order to zeros, one k at a time (each token at
    most once a pass, so the adds are exact in any order on the card), and
    no (T, K, F) tensor of every slot is made: under EP a rank holds 1/M
    of the slots."""
    c = ys * g.reshape(-1)[sel][:, None].to(ys.dtype)
    y = torch.zeros((T, ys.shape[1]), dtype=ys.dtype, device=ys.device)
    tok, k = torch.div(sel, K, rounding_mode="floor"), sel % K
    for j in range(K):
        at = k == j
        y.index_add_(0, tok[at], c[at])
    return y


def _padded_moe_ffn(params, x, gates, logical_idx, placement, E, K, cf,
                    e0: int = 0):
    """Capacity-padded expert FFN, grouped per batch row (GShard grouping):
    each row queues its token slots per physical expert in token-major,
    k-minor order; slots past the capacity C go to the trash row ``E*C``
    and are dropped. The three products run on the ``(E, B*C, D)`` buffer
    through ``moe_gmm``; each f32 result is cast to the activation dtype,
    as the reference's einsums return it.

    Under expert parallelism ``params`` hold the experts of physical slots
    [e0, e0 + E_loc) only: the buffer is theirs, every other slot goes to
    the trash row, and the output holds their gate-weighted sum alone. An
    expert's queue counts only its own slots, so its positions, and which
    slots it drops, are those of the whole layer."""
    B, S, D = x.shape
    dt = x.dtype
    C = max(int(-(-S * K * cf // E)), 4)           # per-row expert capacity
    flat_e = placement.long()[logical_idx.long()].reshape(B, S * K)
    E_loc = params["w_gate"].shape[0]
    local = None
    if E_loc != E:
        local = (flat_e >= e0) & (flat_e < e0 + E_loc)
        flat_e = torch.where(local, flat_e - e0, torch.full_like(flat_e,
                                                                E_loc))
    # position of each slot within its expert's queue: exclusive cumsum of
    # the one-hot over the row's slots
    oh = F.one_hot(flat_e, E_loc if local is None else E_loc + 1)
    pos = (torch.cumsum(oh, dim=1) - oh).gather(2, flat_e[..., None])[..., 0]
    keep = pos < C if local is None else local & (pos < C)
    E = E_loc
    dest = torch.where(keep, flat_e * C + pos,
                       torch.full_like(pos, E * C))          # (B, S*K)
    bidx = torch.arange(B, device=x.device)[:, None]
    updates = x[:, :, None, :].expand(B, S, K, D).reshape(B, S * K, D)
    buf = torch.zeros((B, E * C + 1, D), dtype=dt, device=x.device)
    buf[bidx, dest] = updates          # drops collide in the trash row only
    xe = buf[:, :E * C].reshape(B, E, C, D).transpose(0, 1) \
        .reshape(E, B * C, D)
    gate = moe_gmm(xe, params["w_gate"]).to(dt)
    up = moe_gmm(xe, params["w_up"]).to(dt)
    h = F.silu(gate.float()).to(dt) * up
    ye = moe_gmm(h, params["w_down"]).to(dt)
    ye_rows = ye.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)
    ybuf = torch.cat([ye_rows, torch.zeros((B, 1, D), dtype=dt,
                                           device=x.device)], dim=1)
    ytok = ybuf[bidx, dest].reshape(B, S, K, D)
    return (ytok * gates[..., None].to(dt)).sum(dim=2)


def moe_layer(params, cfg, x, placement, *, source_ids=None,
              n_sources: int = 0, policy=None, collect_stats: bool = True,
              ragged: bool = True, token_mask=None,
              capacity_factor: Optional[float] = None):
    """x: (B, S, D) -> (y (B, S, D), stats dict).

    placement: (E,) int32 logical->physical slot permutation.
    source_ids: (B,) int32 DP-source id per batch row (for A[s, e]).
    ragged: the sort-based dropless dispatch (default) or, when False, the
    capacity-padded one, whose tokens past an expert's capacity are
    dropped (``capacity_factor`` overrides the config's).
    token_mask: (B, S) bool — tokens to count in the routing statistics
    (padding rows and inactive decode lanes are False). Compute is
    unaffected; only the reported load is masked.
    policy: over several ranks, :func:`_sharded_moe_layer` (EP).
    """
    m = cfg.moe
    B, S, D = x.shape
    K, E = m.top_k, m.n_experts
    gates, logical_idx, probs = route(params, cfg, x)
    src = None
    if source_ids is not None:
        src = source_ids[:, None].expand(B, S)
    cf = capacity_factor if capacity_factor is not None \
        else m.capacity_factor
    if policy is not None and policy.world_size > 1:
        return _sharded_moe_layer(params, cfg, x, placement, gates,
                                  logical_idx, probs, src, n_sources,
                                  collect_stats, ragged, token_mask, cf,
                                  policy)
    if ragged:
        y, stats = _ragged_moe_ffn(params, x, gates, logical_idx, placement,
                                   E, K, src, n_sources, collect_stats,
                                   token_mask=token_mask)
        return _moe_epilogue(params, cfg, x, y.to(x.dtype), stats, probs,
                             logical_idx, E, K)

    stats = {}
    if collect_stats:
        stats = _routing_stats(logical_idx, E, src, n_sources, token_mask,
                               False)
    if S == 1 and B > 1:
        # decode: the whole batch is ONE dispatch group, not B groups of
        # capacity 4 each
        y = _padded_moe_ffn(params, x.reshape(1, B, D),
                            gates.reshape(1, B, K),
                            logical_idx.reshape(1, B, K), placement, E, K,
                            cf).reshape(B, 1, D)
    else:
        y = _padded_moe_ffn(params, x, gates, logical_idx, placement, E, K,
                            cf)
    return _moe_epilogue(params, cfg, x, y, stats, probs, logical_idx, E, K)


def _moe_epilogue(params, cfg, x, y, stats, probs, logical_idx, E, K,
                  policy=None, red=(), gather=()):
    """Both dispatch paths: the shared-expert branch on the layer's input
    (the reference runs it on the decode regroup's ``(1, B, D)`` view of
    ``x``; ``@`` folds the leading dimensions, so the rows are the same),
    and the router aux loss (train-time load balancing) from the routing
    probabilities, added to ``stats``. Returns (y, stats).

    Under a policy ``y`` yields, for each rank c of ``gather`` in turn, the
    tokens that rank holds and this rank's f32 part of their sum over the
    axes ``red``: the shared expert's part joins it where its parts are
    summed over axes of ``red`` (:func:`_shared_part`, else summed on its
    own), the block's sum is all_reduced, and this rank keeps its own
    block (``ShardingPolicy.keep_own``, whose backward hands each block its
    owner's gradient). One block at a time, so the sums of all the
    gathered tokens (a million rows at 16 data ranks) never exist at once.
    The statistics and the aux loss's batch means are summed over the
    batch axes."""
    if policy is None:
        if cfg.moe.n_shared_experts:
            y = y + mlp(params["shared"], x)
    else:
        shared = params["shared"] if cfg.moe.n_shared_experts else None
        inside = shared is not None and \
            set(_shared_axes(cfg, policy)) <= set(red)
        me, kept = policy.index(gather), None
        for c, (xc, part) in enumerate(y):
            if inside:
                sh, _ = _shared_part(shared, cfg, x, xc, policy, red,
                                     gather)
                if sh is not None:
                    part = part + sh
            part = policy.all_reduce(part, red)
            kept = policy.keep_own(kept, part, c == me, gather)
        y = kept
        if shared is not None and not inside:
            _, after = _shared_part(shared, cfg, x, None, policy, red,
                                    gather)
            y = y + after
        y = y.to(x.dtype)
    probs_mean = probs.reshape(-1, E).mean(dim=0)
    frac = F.one_hot(logical_idx.reshape(-1, K).long(), E).float() \
        .sum(dim=1).mean(dim=0)
    if policy is not None:
        ba = policy.batch_axes
        n_b = policy.size(ba)
        stats = {k: policy.all_reduce(v, ba) for k, v in stats.items()}
        probs_mean = policy.all_reduce(probs_mean, ba) / n_b
        frac = policy.all_reduce(frac, ba) / n_b
    stats["aux_loss"] = E * torch.sum(probs_mean * frac)
    return y, stats


def _shared_part(shared, cfg, x, xg, policy, red, gather):
    """A MoE layer's shared expert under a policy -> (this rank's f32 part
    of the sum over ``red`` for the tokens ``xg`` (one rank's block of
    ``x`` gathered over ``gather``), or None; else the shared output for
    this rank's rows of ``x``, or None).

    The shared output is a sum of parts over ``model`` where the spec cuts
    the shared stack's super-blocks over it (one ``model`` rank holds the
    layer's, its leaves None on the others) and over the FFN axes under
    ``expert_data_shard`` where they cut its FFN dimension. Where those
    axes are among ``red`` its part joins the routed experts' sum (on an
    axis of ``red`` over which the weights are whole, only that axis's
    rank 0 adds them; under autograd the others add zeros tied to the
    weights, whose gradient is summed over the axis). Otherwise its parts
    are gathered and summed on their own."""
    from repro_torch.models.transformer import n_super_blocks
    M = policy.model_axis
    fs_cut = _shared_cut(cfg, policy)
    by_layer = policy.splits(n_super_blocks(cfg), M)
    parts = _shared_axes(cfg, policy)
    held = shared["w_gate"] is not None
    if set(parts) <= set(red):
        if not held:                   # another model rank's layer
            return None, None
        grad = torch.is_grad_enabled() and xg.requires_grad
        coords = policy.mesh.coords()
        whole = tuple(a for a in red
                      if (a == M and not by_layer)
                      or (a in policy.eds_axes and not fs_cut and a != M))
        first = not any(coords[a] for a in whole)
        if not grad:
            return (mlp(shared, xg).float() if first else None), None
        w = {k: policy.enter(v, whole) for k, v in shared.items()}
        if first:
            return mlp(w, xg).float(), None
        return zeros_tied(tuple(xg.shape), xg, *w.values()), None
    # the shared expert's parts are summed over axes the routed experts'
    # are not: gather its tokens and sum its parts on their own
    sg = tuple(a for a in policy.batch_axes if fs_cut and a in
               policy.eds_axes)
    xs = policy.all_gather(x, sg, 0, sum_axes=parts)
    part = mlp(shared, xs).float() if held else \
        zeros_tied(tuple(xs.shape), xs)
    return None, policy.split(policy.all_reduce(part, parts), sg, 0)


def _shared_cut(cfg, policy) -> bool:
    m = cfg.moe
    return policy.splits(m.n_shared_experts * m.d_shared, policy.eds_axes)


def _shared_axes(cfg, policy):
    """The axes the shared expert's output is a sum of parts over."""
    from repro_torch.models.transformer import n_super_blocks
    M = policy.model_axis
    by_layer = policy.splits(n_super_blocks(cfg), M)
    fs_cut = _shared_cut(cfg, policy)
    return tuple(a for a in policy.mesh.axis_names
                 if (a == M and by_layer) or (fs_cut and a in
                                              policy.eds_axes))


def _sharded_moe_layer(params, cfg, x, placement, gates, logical_idx, probs,
                       src, n_sources, collect_stats, ragged, token_mask, cf,
                       policy):
    """``moe_layer`` on the ranks of a policy: EP over ``model``, the
    expert FFN dimension over the data axes under ``expert_data_shard``.

    After attention's all_reduce every rank of a ``model`` group holds the
    same tokens, so no all_to_all is needed: each rank routes them
    (router replicated), runs the slots routed to its own E/M experts
    through the same dispatch (ragged, or capacity-padded) and adds their
    gate-weighted outputs; an all_reduce over ``model`` (and over the data
    axes whose ranks hold the other FFN blocks) sums the parts. Where the
    ranks of a data axis hold other FFN blocks of the same experts, they
    first all_gather their tokens (``ShardingPolicy.gather_blocks``); the
    parts are then summed one rank's block of tokens at a time, and each
    rank keeps its own (:func:`_moe_epilogue`). The padded path's decode
    regroup (the reference's one dispatch group of the whole batch at
    S == 1) gathers the whole batch over the batch axes, so that capacity
    and queue positions are those of the global batch. The statistics are
    counted over this rank's tokens and summed over the batch axes
    (:func:`_moe_epilogue`)."""
    m = cfg.moe
    B, S, D = x.shape
    K, E = m.top_k, m.n_experts
    M, ba = policy.model_axis, policy.batch_axes
    stats = _routing_stats(logical_idx, E, src, n_sources, token_mask,
                           ragged) if collect_stats else {}
    ep = policy.splits(E, M)
    e0 = policy.index(M) * (E // policy.model_size) if ep else 0
    f_cut = policy.splits(m.d_expert, policy.eds_axes)
    regroup = not ragged and S == 1 and B * policy.size(ba) > 1
    gather = ba if regroup else \
        tuple(a for a in ba if f_cut and a in policy.eds_axes)
    red = tuple(a for a in policy.mesh.axis_names
                if (a == M and ep) or (f_cut and a in policy.eds_axes))
    # each rank's experts read the gathered tokens and gates: their
    # gradients are summed over red before this rank's rows are kept
    if regroup:      # one dispatch group of the whole batch, then its rows
        xg, gg = (policy.all_gather(t, gather, 0, sum_axes=red)
                  for t in (x, gates))
        ig = policy.all_gather(logical_idx, gather, 0)
        Bg = xg.shape[0]
        y = _padded_moe_ffn(params, xg.reshape(1, Bg, D),
                            gg.reshape(1, Bg, K), ig.reshape(1, Bg, K),
                            placement, E, K, cf, e0).reshape(Bg, 1, D)
        blocks = zip(xg.split(B), y.float().split(B))
    else:            # one rank's tokens at a time
        xs, gs = (policy.gather_blocks(t, gather, red) for t in (x, gates))
        ids = policy.gather_blocks(logical_idx, gather)
        if ragged:
            _, parts = _ragged_blocks(params, xs, gs, ids, placement, E, K,
                                      e0)
        else:        # the padded dispatch groups each row on its own
            parts = (_padded_moe_ffn(params, xc, gc, ic, placement, E, K, cf,
                                     e0).float()
                     for xc, gc, ic in zip(xs, gs, ids))
        blocks = zip(xs, parts)
    return _moe_epilogue(params, cfg, x, blocks, stats, probs, logical_idx,
                         E, K, policy, red, gather)


def moved_slots(old_placement, new_placement):
    """(dst, src) physical slots of one layer, as CPU int64 tensors: slot
    ``dst`` takes the weights of slot ``src``, the old slot of the logical
    expert it holds under ``new_placement``; slots that keep their expert
    are left out."""
    old = torch.as_tensor(old_placement).to("cpu", torch.long)
    new = torch.as_tensor(new_placement).to("cpu", torch.long)
    ar = torch.arange(old.shape[0])
    inv_new = torch.empty_like(new)
    inv_new[new] = ar
    # physical slot p_new holds logical expert inv_new[p_new]; its source
    # slot is old_placement[inv_new[p_new]]
    src = old[inv_new]
    dst = torch.nonzero(src != ar).flatten()
    return dst, src[dst]


def _cycles(dst, src):
    """The moved slots as cycles [p0, p1, ..., pL-1]: slot p_k takes the
    weights of slot p_k+1, and the last those of p0."""
    take = dict(zip(dst.tolist(), src.tolist()))
    cycles = []
    while take:
        p, cyc = next(iter(take)), []
        while p in take:
            cyc.append(p)
            p = take.pop(p)
        cycles.append(cyc)
    return cycles


def migrate_expert_weights(params, old_placement, new_placement):
    """Reorder physical expert weights when the placement changes, in
    place: weights[new_phys] = weights[old_phys] for each logical expert,
    bit for bit the reference's functional result. Each cycle of the
    permutation is followed with a buffer of one expert row (its first
    row set aside, each slot taking its successor's, the last taking the
    buffer), so a move holds one row of one tensor beside the weights;
    slots that keep their expert are not touched, nor is any other leaf.
    Returns ``params``."""
    cycles = _cycles(*moved_slots(old_placement, new_placement))
    if not cycles:
        return params
    for name in EXPERT_LEAVES:
        w = params[name]
        buf = torch.empty_like(w[0])
        for cyc in cycles:
            buf.copy_(w[cyc[0]])
            for a, b in zip(cyc, cyc[1:]):
                w[a].copy_(w[b])
            w[cyc[-1]].copy_(buf)
        del buf                   # before the next tensor's buffer
    return params
