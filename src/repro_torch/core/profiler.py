"""Online expert-traffic profiling (paper §5.1).

Two statistics, collected along the normal MoE dispatch path:
  B[l, e]    — aggregate tokens routed to expert e in layer l (EPLB signal)
  A[l, s, e] — tokens from DP source s routed to expert e in layer l
               (Gimbal's source-aware matrix; logical expert ids)

The model's MoE layers emit these per step (moe.expert_statistics — the
fused Pallas kernel provides the zero-overhead collection path, see
kernels/source_expert_count); this class accumulates profiling windows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ExpertProfiler:
    def __init__(self, n_moe_layers: int, n_experts: int, n_sources: int):
        self.L = n_moe_layers
        self.E = n_experts
        self.S = n_sources
        self._B = np.zeros((self.L, self.E), np.int64)
        self._A = np.zeros((self.L, self.S, self.E), np.int64)
        self.window_tokens = 0

    def record_step(self, expert_counts, source_expert=None,
                    n_tokens: Optional[int] = None) -> None:
        """expert_counts: (L, E); source_expert: (L, S, E) (both per-step).

        ``n_tokens``: actual tokens processed this step. The routed-entry
        count is n_tokens * top_k * L — using it for window accounting would
        shrink the effective window by that factor, so callers pass the true
        token count."""
        b = np.asarray(expert_counts)
        self._B += b.astype(np.int64)
        if source_expert is not None:
            self._A += np.asarray(source_expert).astype(np.int64)
        self.window_tokens += int(b.sum()) if n_tokens is None \
            else int(n_tokens)

    def record_routing(self, layer: int, source: int, expert_ids) -> None:
        """Control-plane path (simulator): raw routed ids for one source."""
        ids, counts = np.unique(np.asarray(expert_ids), return_counts=True)
        self._B[layer, ids] += counts
        self._A[layer, source, ids] += counts
        self.window_tokens += int(counts.sum())

    def snapshot(self, reset: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        B, A = self._B.copy(), self._A.copy()
        if reset:
            self._B[:] = 0
            self._A[:] = 0
            self.window_tokens = 0
        return B, A

    def per_rank_load(self, assign: np.ndarray, n_ranks: int) -> np.ndarray:
        """Current-window tokens per EP rank under assignment (L, E)->rank."""
        out = np.zeros((self.L, n_ranks), np.int64)
        for l in range(self.L):
            np.add.at(out[l], assign[l], self._B[l])
        return out
