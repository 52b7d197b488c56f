"""Sort-based ragged MoE dispatch (MegaBlocks-style).

  1. **sort**: stable argsort of the flattened ``(T*K,)`` physical expert
     ids, so within-expert token order is deterministic;
  2. **group_sizes**: one bincount over the same ids (the physical B[e]);
  3. **gather**: tokens placed contiguously per expert, each group's start
     aligned up to a ``row_block`` boundary so every row tile of the grouped
     matmul belongs to exactly one expert (pad rows are zero);
  4. **ragged GMM** (``kernels/moe_gmm.moe_gmm_ragged``): FLOPs scale with
     the real tokens per expert;
  5. **unsort-combine**: gather each token's K expert outputs back and
     reduce them with the router gates.

``ragged_gmm`` is differentiable (dx on the same kernel, dw in PyTorch
ops, as the reference's ``custom_vjp``), so training takes the ragged
path too.

Every index array is int32 and identical to the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.moe_gmm import moe_gmm_ragged, moe_gmm_ragged_plain


def pick_row_block(total_rows: int, n_experts: int,
                   max_block: int = 128) -> int:
    """Largest row-tile (multiple of 8, <= max_block) whose worst-case
    per-group alignment padding (~E * nb rows) stays below HALF the real
    row count — keeps decode-sized dispatches from drowning in tile padding
    while leaving large prefill batches on full 128-row tiles."""
    nb = max_block
    while nb > 8 and n_experts * nb > max(total_rows // 2, 8):
        nb //= 2
    return max(nb, 8)


@dataclasses.dataclass
class RaggedDispatch:
    """Sorted block-aligned token layout + the metadata the GMM needs."""
    xs: torch.Tensor              # (Np, D) tokens grouped by expert, zero-padded
    dest: torch.Tensor            # (T*K,) row in xs for each (token, k) slot
    group_sizes: torch.Tensor     # (E,) real tokens per physical expert  (B[e])
    group_offsets: torch.Tensor   # (E + 1,) exclusive prefix sum of group_sizes
    padded_offsets: torch.Tensor  # (E + 1,) block-aligned group starts in xs
    tile_expert: torch.Tensor     # (Np // row_block,) owning expert per row tile
    sort_idx: torch.Tensor        # (T*K,) stable argsort of the physical ids
    row_block: int                # tile height used for alignment


def padded_rows(total_rows: int, n_experts: int, row_block: int) -> int:
    """Worst-case row count of the block-aligned sorted buffer."""
    worst = total_rows + n_experts * (row_block - 1)
    return -(-worst // row_block) * row_block


def _exclusive_cumsum(t):
    return torch.cat([t.new_zeros(1), torch.cumsum(t, 0, dtype=torch.int32)])


def ragged_dispatch(x2d, phys_idx, n_experts: int, *,
                    row_block: int) -> RaggedDispatch:
    """x2d (T, D); phys_idx (T, K) physical expert ids -> RaggedDispatch.

    Token replica (t, k) lands at row ``dest[t*K + k]`` of ``xs``; rows of
    ``xs`` not hit by any token are zero.
    """
    T, D = x2d.shape
    K = phys_idx.shape[-1]
    TK = T * K
    E = n_experts
    nb = row_block
    dev = x2d.device

    flat_e = phys_idx.reshape(TK).to(torch.int32)
    sort_idx = torch.argsort(flat_e, stable=True).to(torch.int32)
    sorted_e = flat_e[sort_idx]

    group_sizes = torch.bincount(flat_e, minlength=E)[:E].to(torch.int32)
    group_offsets = _exclusive_cumsum(group_sizes)
    aligned = (group_sizes + nb - 1) // nb * nb          # per-group round-up
    padded_offsets = _exclusive_cumsum(aligned)

    rank = torch.arange(TK, dtype=torch.int32, device=dev) \
        - group_offsets[sorted_e]
    dest_sorted = padded_offsets[sorted_e] + rank        # (TK,)
    dest = torch.zeros(TK, dtype=torch.int32, device=dev)
    dest[sort_idx.long()] = dest_sorted

    Np = padded_rows(TK, E, nb)
    src = torch.full((Np,), -1, dtype=torch.int32, device=dev)
    src[dest_sorted.long()] = sort_idx
    tok = torch.clamp(torch.div(src, K, rounding_mode="floor"), 0, T - 1)
    xs = torch.where((src >= 0)[:, None], x2d[tok.long()],
                     torch.zeros((), dtype=x2d.dtype, device=dev))

    tile_starts = torch.arange(Np // nb, dtype=torch.int32, device=dev) * nb
    tile_expert = torch.clamp(
        torch.searchsorted(padded_offsets[1:].contiguous(), tile_starts,
                           right=True, out_int32=True), 0, E - 1)

    return RaggedDispatch(
        xs=xs, dest=dest, group_sizes=group_sizes,
        group_offsets=group_offsets, padded_offsets=padded_offsets,
        tile_expert=tile_expert, sort_idx=sort_idx, row_block=nb)


def ragged_combine(ys, dest, gates):
    """ys (Np, F) expert outputs; dest (T*K,); gates (T, K) -> (T, F)."""
    T, K = gates.shape
    ytok = ys[dest.long()].reshape(T, K, ys.shape[-1])
    return torch.sum(ytok * gates[..., None].to(ytok.dtype), dim=1)


# row tiles per weight-grad slab: the backward holds one f32
# (_DW_CHUNK_TILES, D, F) slab of per-tile products at a time, as the
# reference's does
_DW_CHUNK_TILES = 64


def ragged_dw(xs, dy, tile_expert, padded_offsets, n_experts: int, *,
              row_block: int):
    """The weight gradient of the ragged GMM, the reference's formulation:
    per-tile outer products ``xs_tileᵀ @ dy_tile`` in f32, in slabs of
    ``_DW_CHUNK_TILES`` tiles, added into an f32 (E, D, F) sum. No
    atomics: ``tile_expert`` is nondecreasing, so an expert's tiles are
    adjacent, and each slab's run of one expert is summed in tile order and
    added to that expert's sum, the same bits on every call. The tiles'
    experts and the live row count come to the host once; tiles past
    ``padded_offsets[E]`` hold only zero rows and are skipped."""
    nb = row_block
    D, F = xs.shape[-1], dy.shape[-1]
    meta = torch.cat([tile_expert.to(torch.int64),
                      padded_offsets[-1:].to(torch.int64)]).tolist()
    te, nt = meta[:-1], meta[-1] // nb
    xb = xs.reshape(-1, nb, D)
    dyb = dy.reshape(-1, nb, F)
    dw = torch.zeros((n_experts, D, F), dtype=torch.float32, device=xs.device)
    for t0 in range(0, nt, _DW_CHUNK_TILES):
        t1 = min(t0 + _DW_CHUNK_TILES, nt)
        slab = torch.bmm(xb[t0:t1].transpose(1, 2).float(),
                         dyb[t0:t1].float())               # (n, D, F)
        a = t0
        while a < t1:
            b = a + 1
            while b < t1 and te[b] == te[a]:
                b += 1
            dw[te[a]] += slab[a - t0:b - t0].sum(dim=0)
            a = b
    return dw


class _RaggedGMM(torch.autograd.Function):
    """The ragged GMM and its gradient. ``kernel``: the forward and dx go
    through ``moe_gmm_ragged`` (the CUDA kernel on a CUDA tensor), else
    through its plain version (the test twin)."""

    @staticmethod
    def forward(ctx, xs, w, tile_expert, group_sizes, padded_offsets,
                row_block, kernel):
        ctx.save_for_backward(xs, w, tile_expert, group_sizes,
                              padded_offsets)
        ctx.row_block, ctx.kernel = row_block, kernel
        gmm = moe_gmm_ragged if kernel else moe_gmm_ragged_plain
        return gmm(xs, w, tile_expert, group_sizes, padded_offsets,
                   n_block=row_block)

    @staticmethod
    def backward(ctx, dy):
        xs, w, te, gs, po = ctx.saved_tensors
        nb = ctx.row_block
        dxs = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.transpose(1, 2).contiguous()                # (E, F, D)
            if ctx.kernel:
                # the kernel takes one operand type: dy is rounded to the
                # weights' (bf16 stays on the tensor cores; f32 is exact)
                dxs = moe_gmm_ragged(dy.to(w.dtype).contiguous(), wt, te,
                                     gs, po, n_block=nb)
            else:
                dxs = moe_gmm_ragged_plain(dy, wt, te, gs, po, n_block=nb)
            dxs = dxs.to(xs.dtype)
        if ctx.needs_input_grad[1]:
            dw = ragged_dw(xs, dy, te, po, w.shape[0], row_block=nb) \
                .to(w.dtype)
        return dxs, dw, None, None, None, None, None


def ragged_gmm(xs, w, tile_expert, group_sizes, padded_offsets,
               row_block: int):
    """Differentiable group-sized GMM over the sorted layout -> (Np, F) f32.

    Forward: ``moe_gmm_ragged`` (the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor). Backward, as the reference's
    ``custom_vjp``: dx is the same ragged GMM against ``wᵀ`` (a contiguous
    (E, F, D) copy), on the same kernel, with ``dy`` rounded to the
    weights' dtype because the kernel takes one operand type (bf16 runs on
    the tensor cores, f32 on the CUDA cores and loses nothing), cast to
    ``xs``'s dtype; dw is :func:`ragged_dw` in PyTorch ops, as the
    reference computes it outside Pallas, cast to ``w``'s dtype. Rows
    past a group's real size get no dx, as they get no output."""
    return _RaggedGMM.apply(xs, w, tile_expert, group_sizes, padded_offsets,
                            row_block, True)


def ragged_gmm_plain(xs, w, tile_expert, group_sizes, padded_offsets,
                     row_block: int):
    """:func:`ragged_gmm` through the plain versions only, with dx in the
    f32 formulation (``dy`` not rounded): the twin that the kernels' forward
    and gradient are held to."""
    return _RaggedGMM.apply(xs, w, tile_expert, group_sizes, padded_offsets,
                            row_block, False)
