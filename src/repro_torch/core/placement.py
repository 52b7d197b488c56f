"""Source-aware expert placement (paper §5.2-5.3).

Decision variable: per-layer assignment of logical experts to EP ranks
(capacity E/G experts per rank). Objective terms per layer:

  C_load = sum_g (L_g - mean_g L)^2          (rank-load balance)
  C_comm = sum_{s,e} A[s,e] * D[s, g(e)]     (source-aware communication)
  C_mig  = M * |{e : g(e) != g0(e)}|         (migration stability)

The online path is the calibrated greedy heuristic (alpha, beta, gamma) =
(1.0, 0.0025, 1.0); core/minlp.py provides the offline reference it is
calibrated against. ``assignment_to_permutation`` converts rank assignments
into the logical->physical slot permutation the MoE layer consumes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    alpha: float = 1.0        # communication weight (fixed, paper §6)
    beta: float = 0.0025      # load weight (MINLP-calibrated)
    gamma: float = 1.0        # migration weight (MINLP-calibrated)
    mig_cost_tokens: float = 1.0e4   # token-equivalents per expert move
    # uncalibrated-greedy ablation setting (paper §7.2): overreacts to
    # short-window load and reshuffles aggressively
    @staticmethod
    def uncalibrated() -> "PlacementConfig":
        return PlacementConfig(alpha=1.0, beta=1.0, gamma=0.0)


def default_distance_matrix(n_sources: int, n_ranks: int,
                            local_cost: float = 0.0,
                            remote_cost: float = 1.0) -> np.ndarray:
    """D[s, g]: comm cost between DP source s and EP rank g.

    Default topology: EP ranks are co-located with DP engines in blocks
    (engine e hosts ranks [e*G/S, (e+1)*G/S), the paper's DP=2/EP=4 layout
    where each DP group hosts half the EP ranks) — traffic staying on the
    source's own ranks is cheap, crossing DP groups costs ``remote_cost``.
    On the TPU torus remote_cost scales with ICI hops.
    """
    per = max(n_ranks // max(n_sources, 1), 1)
    D = np.full((n_sources, n_ranks), remote_cost, np.float64)
    for g in range(n_ranks):
        e = min(g // per, n_sources - 1)
        D[e, g] = local_cost
    return D


def torus_distance_matrix(n_sources: int, n_ranks: int) -> np.ndarray:
    """ICI-hop distances on the (data=16, model=16) torus: source row s's
    traffic to expert column g pays the ring distance on the model axis
    weighted per-chip (see DESIGN.md §4)."""
    D = np.zeros((n_sources, n_ranks), np.float64)
    for s in range(n_sources):
        for g in range(n_ranks):
            d = abs((s * n_ranks // max(n_sources, 1)) % n_ranks - g)
            D[s, g] = min(d, n_ranks - d)
    return D


# --------------------------------------------------------------- objective
def layer_objective(assign: np.ndarray, B_l: np.ndarray, A_l: np.ndarray,
                    D: np.ndarray, prev: Optional[np.ndarray],
                    cfg: PlacementConfig) -> Tuple[float, float, float]:
    """Exact per-layer (C_load, C_comm, C_mig) for assignment (E,)->rank."""
    G = D.shape[1]
    loads = np.zeros(G)
    np.add.at(loads, assign, B_l)
    c_load = float(np.sum((loads - loads.mean()) ** 2))
    c_comm = float(np.sum(A_l * D[:, assign]))
    c_mig = 0.0 if prev is None else \
        float(cfg.mig_cost_tokens * np.sum(assign != prev))
    return c_load, c_comm, c_mig


def total_objective(assign, B_l, A_l, D, prev, cfg: PlacementConfig) -> float:
    cl, cc, cm = layer_objective(assign, B_l, A_l, D, prev, cfg)
    return cfg.alpha * cc + cfg.beta * cl + cfg.gamma * cm


# --------------------------------------------------------------- greedy
def greedy_layer_placement(B_l: np.ndarray, A_l: np.ndarray, D: np.ndarray,
                           prev: Optional[np.ndarray],
                           cfg: PlacementConfig,
                           refine_sweeps: int = 1) -> np.ndarray:
    """Paper §5.3: hotness-descending greedy with local score
    S(e, g) = alpha*C_comm + beta*C_load + gamma*C_mig, ties preferring
    no-migration then less-filled ranks — plus ``refine_sweeps`` passes of
    exact-delta single-expert relocation (O(E*G) each, online-cheap)."""
    E = B_l.shape[0]
    G = D.shape[1]
    cap = -(-E // G)
    order = np.argsort(-(B_l.astype(np.float64)
                         + A_l.sum(axis=0)))          # hotness descending
    loads = np.zeros(G)
    counts = np.zeros(G, np.int64)
    assign = np.full(E, -1, np.int64)
    for e in order:
        feasible = np.flatnonzero(counts < cap)
        c_comm = A_l[:, e] @ D[:, feasible]           # (len(feasible),)
        # increase of sum_g L_g^2 (== squared-deviation term up to consts),
        # so the local score matches the MINLP objective structure
        c_load = 2.0 * loads[feasible] * B_l[e] + B_l[e] ** 2
        if prev is None:
            c_mig = np.zeros(len(feasible))
            prev_g = -1
        else:
            prev_g = prev[e]
            c_mig = np.where(feasible == prev_g, 0.0, cfg.mig_cost_tokens)
        s = cfg.alpha * c_comm + cfg.beta * c_load + cfg.gamma * c_mig
        # tie-breaks: no-migration first, then less-filled
        tie = 1e-9 * counts[feasible] - 1e-6 * (feasible == prev_g)
        g = feasible[np.argmin(s + tie)]
        assign[e] = g
        loads[g] += B_l[e]
        counts[g] += 1

    # ---- refinement: exact-objective relocations until no improvement
    comm_cols = A_l.T @ D                              # (E, G)
    for _ in range(max(refine_sweeps, 0)):
        improved = False
        for e in order:
            g1 = assign[e]
            b = B_l[e]
            for g2 in range(G):
                if g2 == g1 or counts[g2] >= cap:
                    continue
                d_load = ((loads[g1] - b) ** 2 + (loads[g2] + b) ** 2
                          - loads[g1] ** 2 - loads[g2] ** 2)
                d_comm = comm_cols[e, g2] - comm_cols[e, g1]
                d_mig = 0.0
                if prev is not None:
                    d_mig = cfg.mig_cost_tokens * (
                        (0.0 if g2 == prev[e] else 1.0)
                        - (0.0 if g1 == prev[e] else 1.0))
                if (cfg.alpha * d_comm + cfg.beta * d_load
                        + cfg.gamma * d_mig) < -1e-12:
                    assign[e] = g2
                    loads[g1] -= b
                    loads[g2] += b
                    counts[g1] -= 1
                    counts[g2] += 1
                    improved = True
                    break
        if not improved:
            break
    return assign


# --------------------------------------------------------------- manager
class PlacementManager:
    """Window-driven expert placement across all MoE layers.

    ``redundant_slots`` > 0 enables **hot-expert replication** (beyond-paper,
    DeepSeek-EPLB style): after the source-aware placement, the R hottest
    experts per layer get an extra replica on the least-loaded rank not
    already hosting them; their traffic splits across copies (and each DP
    source routes to its *nearest* copy, which cuts cross-DP traffic too).
    """

    def __init__(self, n_moe_layers: int, n_experts: int, n_ranks: int,
                 n_sources: int, cfg: Optional[PlacementConfig] = None,
                 D: Optional[np.ndarray] = None, redundant_slots: int = 0):
        self.L, self.E, self.G = n_moe_layers, n_experts, n_ranks
        self.cfg = cfg or PlacementConfig()
        self.D = D if D is not None else default_distance_matrix(
            n_sources, n_ranks)
        # initial: block assignment (expert e -> rank e // (E/G))
        cap = -(-n_experts // n_ranks)
        self.assign = np.stack([np.arange(n_experts) // cap
                                for _ in range(n_moe_layers)]).astype(np.int64)
        self.R = redundant_slots
        self.replica_expert = np.full((self.L, max(self.R, 1)), -1, np.int64)
        self.replica_rank = np.full((self.L, max(self.R, 1)), -1, np.int64)
        self.n_rebalances = 0
        self.n_migrations = 0

    def update(self, B: np.ndarray, A: np.ndarray) -> List[Tuple[int, int, int, int]]:
        """End-of-window rebalance. Returns migration plan
        [(layer, expert, from_rank, to_rank), ...]."""
        new_assign, plan = self.solve(B, A)
        return self.commit(new_assign, plan, B)

    def solve(self, B: np.ndarray, A: np.ndarray
              ) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
        """Pure decision half of :meth:`update`: the placement the window's
        (or forecast) load calls for, WITHOUT committing it. Returns
        ``(new_assign (L, E), plan)`` — the predictive pipeline stages a
        weight prefetch against this and :meth:`commit`\\ s once it lands."""
        new_assign = self.assign.copy()
        plan = []
        for l in range(self.L):
            if B[l].sum() == 0:
                continue
            new = greedy_layer_placement(B[l], A[l], self.D, self.assign[l],
                                         self.cfg)
            moved = np.flatnonzero(new != self.assign[l])
            for e in moved:
                plan.append((l, int(e), int(self.assign[l, e]), int(new[e])))
            new_assign[l] = new
        return new_assign, plan

    def commit(self, new_assign: np.ndarray,
               plan: List[Tuple[int, int, int, int]],
               B: np.ndarray) -> List[Tuple[int, int, int, int]]:
        """Adopt a solved placement (replica re-placement rides along)."""
        self.assign[:] = new_assign
        plan = list(plan)
        if self.R > 0:
            for l in range(self.L):
                if B[l].sum() == 0:
                    continue
                plan += self._place_replicas(l, B[l])
        if plan:
            self.n_rebalances += 1
            self.n_migrations += len(plan)
        return plan

    def _place_replicas(self, l: int, B_l: np.ndarray):
        """Replicate the R hottest experts onto the least-loaded other
        ranks; counted as migrations (a replica is a weight copy)."""
        plan = []
        loads = np.zeros(self.G)
        np.add.at(loads, self.assign[l], B_l)
        hot = np.argsort(-B_l)[: self.R]
        old_e = self.replica_expert[l].copy()
        old_g = self.replica_rank[l].copy()
        for i, e in enumerate(hot):
            home = self.assign[l, e]
            cand = np.argsort(loads)
            g = next(int(c) for c in cand if c != home)
            if old_e[i] != e or old_g[i] != g:
                plan.append((l, int(e), int(home), int(g)))
            self.replica_expert[l, i] = e
            self.replica_rank[l, i] = g
            # the copy takes half the expert's traffic off the home rank
            loads[home] -= B_l[e] / 2.0
            loads[g] += B_l[e] / 2.0
        return plan

    def permutations(self) -> np.ndarray:
        """(L, E) logical->physical slot permutation for the MoE layers."""
        return self.permutations_of(self.assign)

    def permutations_of(self, assign_stack: np.ndarray) -> np.ndarray:
        """Permutations for an un-committed assignment stack (the staged
        placement a prefetch is copying weights for)."""
        return np.stack([assignment_to_permutation(assign_stack[l], self.G)
                         for l in range(self.L)])

    def per_rank_load(self, B: np.ndarray) -> np.ndarray:
        out = np.zeros((self.L, self.G), np.float64)
        for l in range(self.L):
            np.add.at(out[l], self.assign[l], B[l])
            if self.R > 0:
                for i in range(self.R):
                    e = self.replica_expert[l, i]
                    g = self.replica_rank[l, i]
                    if e >= 0 and g >= 0 and self.assign[l, e] != g:
                        half = B[l, e] / 2.0
                        out[l, self.assign[l, e]] -= half
                        out[l, g] += half
        return out

    def distance_of(self, l: int, s: int, e: int) -> float:
        """Source s's comm distance to expert e's NEAREST copy in layer l."""
        d = self.D[s, self.assign[l, e]]
        if self.R > 0:
            for i in range(self.R):
                if self.replica_expert[l, i] == e and \
                        self.replica_rank[l, i] >= 0:
                    d = min(d, self.D[s, self.replica_rank[l, i]])
        return float(d)


def assignment_to_permutation(assign: np.ndarray, n_ranks: int) -> np.ndarray:
    """rank assignment (E,) -> logical->physical slot permutation (E,).

    Physical slots [g*cap, (g+1)*cap) live on rank g; experts assigned to g
    fill its slots in logical order (stable)."""
    E = assign.shape[0]
    cap = -(-E // n_ranks)
    perm = np.full(E, -1, np.int64)
    fill = np.zeros(n_ranks, np.int64)
    for e in range(E):
        g = assign[e]
        perm[e] = g * cap + fill[g]
        fill[g] += 1
    return perm
