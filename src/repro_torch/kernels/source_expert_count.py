"""Source-aware expert statistics in one pass over the router output:

  B[e]    tokens routed to expert e            (aggregate load)
  A[s, e] tokens from DP source s to expert e  (source-aware matrix)

Ids outside ``[0, E)`` and sources outside ``[0, S)`` count nowhere; B
counts every valid expert id whatever its source. ``source_expert_count``
launches ``csrc/source_expert_count.cu`` (shared-memory histogram flushed
with global atomics, the paper's formulation) on a CUDA tensor and runs
``source_expert_count_plain`` on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def source_expert_count_plain(expert_idx, source_ids, *, n_experts: int,
                              n_sources: int):
    """Scatter-add version. expert_idx (T, K); source_ids (T,)."""
    K = expert_idx.shape[-1]
    flat = expert_idx.reshape(-1).long()
    src = torch.repeat_interleave(source_ids.reshape(-1).long(), K)
    valid = (flat >= 0) & (flat < n_experts)
    b = torch.bincount(flat[valid], minlength=n_experts)
    sv = valid & (src >= 0) & (src < n_sources)
    a = torch.bincount(src[sv] * n_experts + flat[sv],
                       minlength=n_sources * n_experts)
    return b.int(), a.reshape(n_sources, n_experts).int()


def source_expert_count(expert_idx, source_ids, *, n_experts: int,
                        n_sources: int):
    """expert_idx (T, K) int32, source_ids (T,) int32 -> (B (E,), A (S, E))
    int32."""
    if expert_idx.device.type == "cpu":
        return source_expert_count_plain(expert_idx, source_ids,
                                         n_experts=n_experts,
                                         n_sources=n_sources)
    if expert_idx.device.type != "cuda":
        raise ValueError("source_expert_count: no kernel for device "
                         f"{expert_idx.device}")
    if expert_idx.dim() != 2 or tuple(source_ids.shape) \
            != (expert_idx.shape[0],):
        raise ValueError("source_expert_count: expert_idx must be (T, K) and "
                         "source_ids (T,)")
    if n_experts <= 0 or n_sources <= 0:
        raise ValueError("source_expert_count: n_experts and n_sources must "
                         "be positive")
    ids = {"expert_idx": expert_idx, "source_ids": source_ids}
    ops.check_int32("source_expert_count", ids)
    ops.check_cuda("source_expert_count", ids, expert_idx.device)
    T, K = expert_idx.shape
    dev = expert_idx.device
    b = torch.empty((n_experts,), dtype=torch.int32, device=dev)
    a = torch.empty((n_sources, n_experts), dtype=torch.int32, device=dev)
    ops.launch("source_expert_count", expert_idx.data_ptr(),
               source_ids.data_ptr(), b.data_ptr(), a.data_ptr(), T, K,
               n_experts, n_sources, device=dev)
    source_expert_count.launches += 1
    return b, a


source_expert_count.launches = 0
