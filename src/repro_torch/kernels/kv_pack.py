"""Int8 KV rows: per-row symmetric quantization (``pack_kv``) and its
inverse (``unpack_kv``).

The paged pool's int8 mode (``PagedEngineConfig.kv_dtype="int8"``) stores
each KV row (one token, one KV head) as int8 values plus one f32 scale,
``scale = max(|row|) / 127``, so a fixed pool holds ``2*hd / (hd + 4)``
times the tokens of the 2-byte layout. Values are
``round_half_even(x / max(scale, 1e-8))``; a zero row gives scale 0 and
zeros.

``pack_kv`` runs on every KV write into int8 pages; ``unpack_kv`` is the
dequantization of gathered pages in chunked prefill (paged decode
dequantizes inside its own kernel). Each launches ``csrc/kv_pack.cu`` on a
CUDA tensor and runs its plain version on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def pack_kv_plain(t):
    """(..., hd) bf16/f32 -> ((..., hd) int8, (...) f32 scales)."""
    x = t.float()
    # divide by a tensor, not a Python number: on a CUDA tensor PyTorch
    # turns division by a scalar into a multiply by its rounded reciprocal,
    # which moves the scale by one ulp on some rows
    s = x.abs().amax(dim=-1) / torch.full((), 127.0, device=x.device)
    q = torch.round(x / torch.clamp(s, min=1e-8)[..., None]).to(torch.int8)
    return q, s


def unpack_kv_plain(q, s, dtype=torch.float32):
    """Inverse of :func:`pack_kv_plain` (up to quantization error)."""
    return (q.float() * s[..., None].float()).to(dtype)


def pack_kv(t):
    """(..., hd) bf16/f32 -> ((..., hd) int8, (...) f32 scales)."""
    if t.device.type == "cpu":
        return pack_kv_plain(t)
    if t.device.type != "cuda":
        raise ValueError(f"pack_kv: no kernel for device {t.device}")
    if t.dtype not in ops.DTYPE_CODE or t.dim() == 0:
        raise TypeError(f"pack_kv: expected a bf16/f32 tensor with a last "
                        f"axis, got {t.dtype} of shape {tuple(t.shape)}")
    t = t.contiguous()
    hd = t.shape[-1]
    q = torch.empty(t.shape, dtype=torch.int8, device=t.device)
    s = torch.empty(t.shape[:-1], dtype=torch.float32, device=t.device)
    ops.launch("pack_kv", t.data_ptr(), q.data_ptr(), s.data_ptr(),
               s.numel(), hd, ops.DTYPE_CODE[t.dtype], device=t.device)
    pack_kv.launches += 1
    return q, s


def unpack_kv(q, s, dtype=torch.float32):
    """(..., hd) int8 codes and (...) f32 scales -> (..., hd) in ``dtype``
    (bf16 or f32)."""
    if q.device.type == "cpu":
        return unpack_kv_plain(q, s, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unpack_kv: no kernel for device {q.device}")
    if q.dtype != torch.int8 or s.dtype != torch.float32 \
            or dtype not in ops.DTYPE_CODE:
        raise TypeError(f"unpack_kv: expected int8 codes, f32 scales and a "
                        f"bf16/f32 output, got {q.dtype}, {s.dtype}, {dtype}")
    if q.dim() == 0 or tuple(s.shape) != tuple(q.shape[:-1]):
        raise ValueError(f"unpack_kv: scales {tuple(s.shape)} do not fit "
                         f"codes {tuple(q.shape)}")
    hd = q.shape[-1]
    q, s = q.contiguous(), s.contiguous()
    ops.check_cuda("unpack_kv", {"q": q, "s": s}, q.device)
    if hd % 16 or q.data_ptr() % 16:
        raise ValueError("unpack_kv: the kernel reads 16 codes per 16-byte "
                         "load: hd must be a multiple of 16 and the codes "
                         "16-byte aligned")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    ops.launch("unpack_kv", q.data_ptr(), s.data_ptr(), out.data_ptr(),
               s.numel(), hd, ops.DTYPE_CODE[dtype], device=q.device)
    unpack_kv.launches += 1
    return out


pack_kv.launches = 0
unpack_kv.launches = 0
