"""Source-aware expert statistics in one pass over the router output:

  B[e]    tokens routed to expert e            (aggregate load)
  A[s, e] tokens from DP source s to expert e  (source-aware matrix)

Ids outside ``[0, E)`` and sources outside ``[0, S)`` count nowhere; B
counts every valid expert id whatever its source, and the counts do not
depend on the order of the slots. ``source_expert_count`` launches
``csrc/source_expert_count.cu`` on a CUDA tensor and runs
``source_expert_count_plain`` on a CPU tensor. Up to
``SINGLE_BLOCK_SLOTS`` slots (every serving step) the kernel is one block
that counts in shared memory and stores every bin: one launch and no
memset. Above it, B and A are zeroed and a grid of blocks flushes its
shared-memory counts with global atomics (the paper's formulation).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch import counting

# The most slots (T * K) counted by one block: on an H100 the block's
# device time meets the grid's (two memsets and the kernel, about 0.004 ms)
# at 8192 slots and passes it by 16384, for random and skewed routing
# alike; host time per call does not tell the two paths apart
# (experiments/bench_torch/stats_paths.py; PERF.md). Every call of
# the int8 cluster serve is under it; a padded prefill group of 4 lanes x
# 512 tokens x top-8 (16384 slots) takes the grid.
SINGLE_BLOCK_SLOTS = 8192


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


def source_expert_count_cost(T, K, E, S):
    """(operations, bytes) of one call: the (T, K) ids and (T,) sources
    read, B (E,) and A (S, E) written, int32; two operations a slot."""
    return 2 * T * K, 4 * (T * K + T + E + S * E)


def _cost_of(expert_idx, source_ids, *, n_experts, n_sources, **_):
    return source_expert_count_cost(expert_idx.shape[0],
                                    expert_idx.shape[-1], n_experts,
                                    n_sources)


@counting.counted("source_expert_count", _cost_of)
def source_expert_count(expert_idx, source_ids, *, n_experts: int,
                        n_sources: int,
                        single_block_slots: int = SINGLE_BLOCK_SLOTS):
    """expert_idx (T, K) int32, source_ids (T,) int32 -> (B (E,), A (S, E))
    int32. ``single_block_slots``: the most slots counted by one block
    (a negative limit always takes the grid)."""
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
               n_experts, n_sources, single_block_slots, device=dev)
    source_expert_count.launches += 1
    return b, a


source_expert_count.launches = 0
