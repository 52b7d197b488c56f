"""Grouped expert matmuls (the MoE expert FFN hot spot), two formulations.

* ``moe_gmm``: the capacity-padded batched GEMM ``y[e] = x[e] @ w[e]`` over
  an ``(E, C, D)`` buffer, every capacity slot multiplied (padding
  included); output ``(E, C, F)`` f32. It carries the padded dispatch of
  ``models/moe.py`` (``moe_layer(ragged=False)``), and its gradient goes
  through the same kernel.

* ``moe_gmm_ragged``: the group-sized ragged GEMM. x is one ``(Np, D)``
  buffer of tokens sorted by expert with block-aligned group starts (see
  ``kernels/moe_dispatch.ragged_dispatch``). Row tile n (``n_block`` rows)
  uses the weights of expert ``tile_expert[n]``; tiles past
  ``padded_offsets[E]`` or wholly inside a group's alignment padding give
  0, and so do rows past the group's real size. Output ``(Np, F)`` is f32.
  Forward only: ``kernels/moe_dispatch.ragged_gmm`` differentiates it.

Each wrapper launches its entry point of ``csrc/moe_gmm.cu`` on a CUDA
tensor and runs its ``*_plain`` version on a CPU tensor. On the card a
launch takes one of two routes, chosen by ``tc_eligible`` from the dtype,
the widths and the pointers alone: bf16 on the tensor cores
(``csrc/gmm_tile.cuh``), or the CUDA cores for f32 inputs and for bf16
shapes the tensor-core tiles cannot take. ``launches`` counts every launch
of a wrapper, ``tc_launches`` those on the tensor cores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch import counting


TC_CODE = 2          # the entry points' dtype code of the tensor-core route


def tc_eligible(dtype, D: int, F: int, *ptrs: int) -> bool:
    """Whether a launch of either GMM takes the tensor-core route: bf16
    inputs, a depth D > 0 and D and the width F multiples of 8 (16-byte
    chunks of a row never straddle an edge, and the weights' rows meet the
    TMA's stride rule) and every pointer 16-byte aligned. f32 stays on the
    CUDA cores by rule: its float32 twins must match the CPU to 1e-4, which
    TF32 would not."""
    return (dtype == torch.bfloat16 and D > 0 and D % 8 == 0
            and F % 8 == 0 and all(p % 16 == 0 for p in ptrs))


def _route_code(x, w, out) -> int:
    D, F = w.shape[-2:]
    if tc_eligible(x.dtype, D, F, x.data_ptr(), w.data_ptr(),
                   out.data_ptr()):
        return TC_CODE
    return ops.DTYPE_CODE[x.dtype]


def moe_gmm_cost(E, C, D, F, item):
    """(FLOPs, bytes) of one padded product: x (E, C, D) and w (E, D, F)
    read in their type, the f32 output written."""
    return 2 * E * C * D * F, (E * C * D + E * D * F) * item + E * C * F * 4


def moe_gmm_ragged_cost(rows, hit, Np, D, F, E, n_tiles, item):
    """(FLOPs, bytes) of one ragged product over ``rows`` live rows of
    ``hit`` experts: the live rows and those experts' weights read, the
    (Np, F) f32 output written, the int32 metadata."""
    nbytes = rows * D * item + hit * D * F * item + Np * F * 4 \
        + 4 * (n_tiles + 2 * E + 1)
    return 2 * rows * D * F, nbytes


def moe_gmm_plain(x, w):
    """x (E, C, D) @ w (E, D, F) -> (E, C, F), in f32."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float())


@counting.counted("moe_gmm", lambda x, w: moe_gmm_cost(
    *x.shape, w.shape[-1], x.element_size()))
def _moe_gmm_launch(x, w):
    """One product: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: no kernel for device {x.device}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    if x.dtype not in ops.DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm: x and w must share a dtype in bf16/f32, "
                        f"got {x.dtype}, {w.dtype}")
    ops.check_cuda("moe_gmm", {"x": x, "w": w}, x.device)
    E, C, D = x.shape
    F = w.shape[-1]
    out = torch.empty((E, C, F), dtype=torch.float32, device=x.device)
    code = _route_code(x, w, out)
    ops.launch("moe_gmm_padded", x.data_ptr(), w.data_ptr(), out.data_ptr(),
               E, C, D, F, code, device=x.device)
    moe_gmm.launches += 1
    moe_gmm.tc_launches += code == TC_CODE
    return out


class _MoeGmm(torch.autograd.Function):
    """The padded product and its gradient, all three products through the
    same kernel: dx = dy @ wᵀ and dw = xᵀ @ dy, each batched over the
    experts. The kernel takes one operand type, so the incoming f32 ``dy``
    is rounded to the inputs' type first; on the padded path it already
    holds values of that type (``models/moe.py`` casts each product's
    output to the activation dtype), so nothing is lost. Each gradient is
    returned in its input's dtype, as ``jnp.einsum``'s is."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _moe_gmm_launch(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _moe_gmm_launch(dy, w.transpose(1, 2).contiguous()) \
                .to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _moe_gmm_launch(x.transpose(1, 2).contiguous(), dy) \
                .to(w.dtype)
        return dx, dw


def moe_gmm(x, w):
    """x (E, C, D), w (E, D, F) in bf16 or f32 -> (E, C, F) f32. Any C, D
    and F: the kernel masks the edges itself. Differentiable: the backward
    launches the kernel twice more (``_MoeGmm``)."""
    return _MoeGmm.apply(x, w)


moe_gmm.launches = 0
moe_gmm.tc_launches = 0


def moe_gmm_ragged_plain(x, w, tile_expert, group_sizes, padded_offsets, *,
                         n_block: int):
    """Same function as the kernel: one f32 product per expert over the
    live rows of the tiles it owns."""
    Np, D = x.shape
    F = w.shape[-1]
    nb = n_block
    nt = Np // nb
    dev = x.device
    e = tile_expert.long()
    row0 = torch.arange(nt, device=dev) * nb
    start = padded_offsets.long()[e]
    size = group_sizes.long()[e]
    live = (row0 < padded_offsets.long()[-1]) & (row0 < start + size)
    local = row0[:, None] + torch.arange(nb, device=dev)[None] - start[:, None]
    keep = live[:, None] & (local < size[:, None])              # (nt, nb)
    xb = x.reshape(nt, nb, D)
    y = torch.zeros((nt, nb, F), dtype=torch.float32, device=dev)
    for ex in torch.unique(e[live]).tolist():
        sel = live & (e == ex)
        y[sel] = xb[sel].float() @ w[ex].float()
    y = torch.where(keep[..., None], y, torch.zeros_like(y))
    return y.reshape(Np, F)


def _ragged_cost_of(x, w, tile_expert, group_sizes, padded_offsets, *,
                    n_block):
    E, D, F = w.shape
    return moe_gmm_ragged_cost(int(group_sizes.sum()),
                               int((group_sizes > 0).sum()), x.shape[0], D,
                               F, E, tile_expert.numel(), x.element_size())


@counting.counted("moe_gmm_ragged", _ragged_cost_of)
def moe_gmm_ragged(x, w, tile_expert, group_sizes, padded_offsets, *,
                   n_block: int):
    """x (Np, D), w (E, D, F) in bf16 or f32; tile_expert (Np // n_block,),
    group_sizes (E,), padded_offsets (E + 1,) int32 -> (Np, F) f32."""
    if x.device.type == "cpu":
        return moe_gmm_ragged_plain(x, w, tile_expert, group_sizes,
                                    padded_offsets, n_block=n_block)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm_ragged: no kernel for device {x.device}")
    Np, D = x.shape
    E, Dw, F = w.shape
    nb = int(n_block)
    if Dw != D:
        raise ValueError(f"moe_gmm_ragged: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    if nb <= 0 or nb % 8 or Np % nb:
        raise ValueError(f"moe_gmm_ragged: n_block {nb} must be a positive "
                         f"multiple of 8 dividing Np={Np}")
    if tuple(tile_expert.shape) != (Np // nb,) \
            or tuple(group_sizes.shape) != (E,) \
            or tuple(padded_offsets.shape) != (E + 1,):
        raise ValueError("moe_gmm_ragged: metadata shapes do not match "
                         f"Np={Np}, n_block={nb}, E={E}")
    if x.dtype not in ops.DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm_ragged: x and w must share a dtype in "
                        f"bf16/f32, got {x.dtype}, {w.dtype}")
    meta = {"tile_expert": tile_expert, "group_sizes": group_sizes,
            "padded_offsets": padded_offsets}
    ops.check_int32("moe_gmm_ragged", meta)
    ops.check_cuda("moe_gmm_ragged", {"x": x, "w": w, **meta}, x.device)
    out = torch.empty((Np, F), dtype=torch.float32, device=x.device)
    code = _route_code(x, w, out)
    ops.launch("moe_gmm", x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(),
               group_sizes.data_ptr(), padded_offsets.data_ptr(),
               out.data_ptr(), Np, D, F, E, nb, code, device=x.device)
    moe_gmm_ragged.launches += 1
    moe_gmm_ragged.tc_launches += code == TC_CODE
    return out


moe_gmm_ragged.launches = 0
moe_gmm_ragged.tc_launches = 0
