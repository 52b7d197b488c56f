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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch import (pick_row_block, ragged_combine,
                                              ragged_dispatch, ragged_gmm)
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.source_expert_count import source_expert_count
from repro_torch.models.layers import dense_init, init_mlp, mlp, torch_dtype


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")    # what a migration moves


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


def _ragged_moe_ffn(params, x, gates, logical_idx, placement, E, K, src2d,
                    n_sources: int, collect_stats: bool, token_mask=None):
    """Sort-based dropless expert FFN: sort physical ids -> group sizes ->
    block-aligned gather -> ragged GMM (gate, up, down) -> gate-weighted
    combine. Issued FLOPs scale with the real tokens per expert."""
    B, S, D = x.shape
    T = B * S
    x2d = x.reshape(T, D)
    phys = placement.long()[logical_idx.long()].reshape(T, K)
    nb = pick_row_block(T * K, E)
    disp = ragged_dispatch(x2d, phys, E, row_block=nb)

    stats = {}
    if collect_stats:
        if token_mask is None:
            # physical slot placement[l] holds logical expert l, so the
            # logical load B[e] is a gather of the sort pass's bincount
            stats["expert_counts"] = disp.group_sizes[placement.long()]
        else:
            # masked tokens still dispatch but must not register load:
            # count the logical ids under the mask instead
            w = torch.repeat_interleave(token_mask.reshape(T).long(), K)
            counts = torch.zeros(E, dtype=torch.long, device=x.device)
            counts.index_add_(0, logical_idx.reshape(T * K).long(), w)
            stats["expert_counts"] = counts.to(torch.int32)
        if src2d is not None and n_sources > 0:
            # the stats kernel on the router's ids as they come (the counts
            # do not depend on order); a masked token's source is -1, which
            # counts nowhere
            ss = src2d if token_mask is None else torch.where(
                token_mask.reshape(src2d.shape), src2d, -1)
            _, a = source_expert_count(
                logical_idx.reshape(T, K).to(torch.int32).contiguous(),
                ss.reshape(T).to(torch.int32).contiguous(), n_experts=E,
                n_sources=n_sources)
            stats["source_expert"] = a

    args = (disp.tile_expert, disp.group_sizes, disp.padded_offsets, nb)
    gate = ragged_gmm(disp.xs, params["w_gate"], *args)
    up = ragged_gmm(disp.xs, params["w_up"], *args)
    h = (F.silu(gate) * up).to(x.dtype)       # f32 on the GMM's f32 outputs
    ys = ragged_gmm(h, params["w_down"], *args)
    y2d = ragged_combine(ys, disp.dest, gates.reshape(T, K))
    return y2d.reshape(B, S, D).to(x.dtype), stats


def _padded_moe_ffn(params, x, gates, logical_idx, placement, E, K, cf):
    """Capacity-padded expert FFN, grouped per batch row (GShard grouping):
    each row queues its token slots per physical expert in token-major,
    k-minor order; slots past the capacity C go to the trash row ``E*C``
    and are dropped. The three products run on the ``(E, B*C, D)`` buffer
    through ``moe_gmm``; each f32 result is cast to the activation dtype,
    as the reference's einsums return it."""
    B, S, D = x.shape
    dt = x.dtype
    C = max(int(-(-S * K * cf // E)), 4)           # per-row expert capacity
    flat_e = placement.long()[logical_idx.long()].reshape(B, S * K)
    # position of each slot within its expert's queue: exclusive cumsum of
    # the one-hot over the row's slots
    oh = F.one_hot(flat_e, E)                                # (B, S*K, E)
    pos = (torch.cumsum(oh, dim=1) - oh).gather(2, flat_e[..., None])[..., 0]
    dest = torch.where(pos < C, flat_e * C + pos,
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
              n_sources: int = 0, collect_stats: bool = True,
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
    """
    m = cfg.moe
    B, S, D = x.shape
    K, E = m.top_k, m.n_experts
    gates, logical_idx, probs = route(params, cfg, x)
    src = None
    if source_ids is not None:
        src = source_ids[:, None].expand(B, S)
    if ragged:
        y, stats = _ragged_moe_ffn(params, x, gates, logical_idx, placement,
                                   E, K, src, n_sources, collect_stats,
                                   token_mask=token_mask)
        return _moe_epilogue(params, cfg, x, y, stats, probs, logical_idx, E,
                             K)

    stats = {}
    if collect_stats:
        stats = expert_statistics(logical_idx, E, src, n_sources,
                                  token_mask=token_mask)
    cf = capacity_factor if capacity_factor is not None \
        else m.capacity_factor
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


def _moe_epilogue(params, cfg, x, y, stats, probs, logical_idx, E, K):
    """Both dispatch paths: the shared-expert branch on the layer's input
    (the reference runs it on the decode regroup's ``(1, B, D)`` view of
    ``x``; ``@`` folds the leading dimensions, so the rows are the same),
    and the router aux loss (train-time load balancing) from the routing
    probabilities, added to ``stats``. Returns (y, stats)."""
    if cfg.moe.n_shared_experts:
        y = y + mlp(params["shared"], x)
    probs_mean = probs.reshape(-1, E).mean(dim=0)
    frac = F.one_hot(logical_idx.reshape(-1, K).long(), E).float() \
        .sum(dim=1).mean(dim=0)
    stats["aux_loss"] = E * torch.sum(probs_mean * frac)
    return y, stats


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
