"""What the two split-KV decode kernels (``paged_decode``, ``flash_decode``)
share on the Python side: the route a launch takes, the context slice each
block of their partial pass covers, the one f32 scratch buffer a call
hands them (``csrc/split_kv_decode.cuh::Partials``), and the yardstick
their outputs are held to against the plain versions.

Routes: bf16 on the tensor cores (``csrc/split_kv_tc.cuh``), or the CUDA
cores for f32 and for bf16 shapes the tensor-core tiles cannot take.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

TC_CODE = 2          # the entry points' dtype code of the tensor-core route
# context tokens (paged) or cache slots (dense) per block of the partial
# pass: a multiple of 32, and the same whatever the batch, the block table
# or the cache length, so a request's partials, and so its output bits, do
# not depend on the other requests of its batch
SPLIT_TOKENS = 128


def tc_eligible(dtype, hd: int, G: int, *ptrs: int) -> bool:
    """Whether a decode launch takes the tensor-core route: bf16, a head
    width hd that is a multiple of 16 (the k16 steps of the products) up to
    128 (q's fragments and the 16 x hd accumulator stay in registers), at
    most 16 query heads per KV head (the A operand's rows) and every
    pointer 16-byte aligned (16-byte cp.async). f32 stays on the CUDA cores
    by rule: its float32 twins must match the CPU to 1e-4."""
    return (dtype == torch.bfloat16 and hd % 16 == 0 and 16 <= hd <= 128
            and 1 <= G <= 16 and all(p % 16 == 0 for p in ptrs))


def route_code(dtype, hd: int, G: int, *ptrs: int) -> int:
    """The dtype code the wrappers pass to the entry points: ``TC_CODE``
    for the tensor cores, else the dtype's own code (CUDA cores)."""
    return TC_CODE if tc_eligible(dtype, hd, G, *ptrs) \
        else ops.DTYPE_CODE[dtype]


def split_plan(n_tokens: int) -> tuple:
    """(split_tokens, n_split) for a context of ``n_tokens`` positions:
    slices of ``SPLIT_TOKENS``, at least one."""
    return SPLIT_TOKENS, max(1, -(-n_tokens // SPLIT_TOKENS))


def scratch(B: int, Hq: int, n_split: int, hd: int,
            device: torch.device) -> torch.Tensor:
    """The call's partials in one f32 buffer: the accumulator
    (B, Hq, n_split, hd) first, for 16-byte alignment, then max and sum
    (B, Hq, n_split) each."""
    return torch.empty(B * Hq * n_split * (hd + 2), dtype=torch.float32,
                       device=device)


# the largest row_rel_err a decode output may show against its plain
# version: bf16 outputs differ by about one rounding of the output (a few
# 1e-3 of a row's norm), f32 sums by their order
ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over requests b of ||out_b - ref_b|| / ||ref_b||, in f32 (0 for a
    row where both are exact zeros, inf where only ``ref_b`` is).

    A decode output row is an average of V rows over the context, so its
    elements shrink as 1/sqrt(context): at 32768 tokens of unit-variance V
    they are about 0.01, and an absolute bar of 3e-2 would pass a kernel
    that dropped a slice or a tenth of the context. Relative to the row's
    own norm, dropping one 128-token slice of 32768 costs about 6e-2."""
    d = (out.float() - ref.float()).flatten(1).norm(dim=1)
    r = ref.float().flatten(1).norm(dim=1)
    rel = torch.where(r > 0, d / r.clamp_min(torch.finfo(torch.float32).tiny),
                      torch.where(d > 0, float("inf"), 0.0))
    return float(rel.max()) if rel.numel() else 0.0
