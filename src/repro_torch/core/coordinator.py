"""Cross-level coordination (paper §3, §5.3 closing paragraph).

The coordinator owns the feedback loop:
  1. MoE layers emit A/B statistics -> ExpertProfiler accumulates a window.
  2. End of window: PlacementManager rebalances -> migration plan (+cost).
  3. Per-rank expert load under the *current* placement is mapped onto the
     co-located DP engines and written back into each engine's trace as
     ``moe_pressure`` — which the DP scheduler consumes (Algorithm 1).
Disabling step 3 gives the paper's "Gimbal-All (No Collaboration)" ablation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.forecast import (ExpertTrafficForecaster, ForecastConfig,
                                 PrefetchConfig, PrefetchCostModel)
from repro_torch.core.placement import PlacementConfig, PlacementManager
from repro_torch.core.profiler import ExpertProfiler
from repro_torch.core.traces import TraceTable


@dataclasses.dataclass(frozen=True)
class CoordinatorConfig:
    window_tokens: int = 200_000        # profiling window size
    feedback: bool = True               # MoE pressure -> DP scheduler
    rebalance: bool = True              # enable expert migration at all
    # expert migration wall-time (paper §2.2.2: 1.08 s first / 0.72 s after
    # for an ALL-layer rearrangement). Cost scales with experts moved:
    # duration = base + per_move * n_moves (+ warmup once).
    migration_base_s: float = 0.08
    migration_per_move_s: float = 1.04e-4   # 0.72s at a full 48x128 reshuffle
    migration_warmup_s: float = 0.36        # first rearrangement extra
    moe_pressure_norm: float = 2000.0   # token-equivalents at 100% excess
    # ---- predictive placement (ROADMAP: forecast + prefetch) -------------
    # predictive: rebalance against the forecaster's next-window (B̂, Â)
    # instead of the window just observed. prefetch: on a placement flip,
    # copy the moving experts' weights to their targets ASYNCHRONOUSLY
    # (overlapped with serving, priced by PrefetchCostModel) and commit
    # the placement pointer only once the copy lands — migration stops
    # costing serving-path wall time (``migrations_hidden``).
    predictive: bool = False
    prefetch: bool = False
    forecast_cfg: Optional[ForecastConfig] = None   # None -> ForecastConfig()
    prefetch_cfg: Optional[PrefetchConfig] = None   # None -> PrefetchConfig()
    flip_s: float = 0.0                 # serving-path cost of a landed flip


class GimbalCoordinator:
    def __init__(self, n_moe_layers: int, n_experts: int, n_ranks: int,
                 n_engines: int, cfg: Optional[CoordinatorConfig] = None,
                 placement_cfg: Optional[PlacementConfig] = None,
                 D: Optional[np.ndarray] = None,
                 on_migration: Optional[Callable] = None,
                 redundant_slots: int = 0):
        self.cfg = cfg or CoordinatorConfig()
        self.n_engines = n_engines
        self.n_ranks = n_ranks
        self.profiler = ExpertProfiler(n_moe_layers, n_experts, n_engines)
        self.placement = PlacementManager(
            n_moe_layers, n_experts, n_ranks, n_engines,
            cfg=placement_cfg, D=D, redundant_slots=redundant_slots)
        self.on_migration = on_migration
        self._migrated_once = False
        self._last_rank_load = np.zeros((max(n_moe_layers, 1), n_ranks))
        self.migration_log: List[Dict] = []
        # ---- predictive placement state ---------------------------------
        self.forecaster = ExpertTrafficForecaster(
            n_moe_layers, n_experts, n_engines,
            cfg=self.cfg.forecast_cfg) if self.cfg.predictive else None
        self.prefetch_cost = PrefetchCostModel(self.cfg.prefetch_cfg) \
            if self.cfg.prefetch else None
        # callback when a prefetch is staged: (plan, target_perms) — the
        # real plane starts the double-buffered weight copy here
        self.on_prefetch: Optional[Callable] = None
        self._pending: Optional[Dict] = None    # staged, un-landed flip
        self._last_B = np.zeros((max(n_moe_layers, 1), n_experts))
        self.prefetch_hits = 0          # staged placements that flipped
        self.prefetch_misses = 0        # staged placements superseded
        self.prefetch_bytes = 0.0
        self.migrations_hidden = 0      # expert moves applied via prefetch
        self.sync_migrations = 0        # rebalances paid on the serving path
        self.sync_stall_s = 0.0         # serving-path migration wall time

    # ---- rank <-> engine co-location (DP+TP+EP share physical chips) ---
    def ranks_of_engine(self, engine_id: int) -> List[int]:
        per = max(self.n_ranks // max(self.n_engines, 1), 1)
        return [engine_id * per + i for i in range(per)
                if engine_id * per + i < self.n_ranks]

    # ---- window lifecycle ----------------------------------------------
    def maybe_rebalance(self, now: float = 0.0) -> Tuple[bool, float]:
        """If the window is full: snapshot, (forecast,) rebalance, migrate.
        Returns (migrated, serving-path migration seconds).

        Predictive mode feeds the forecaster's next-window (B̂, Â) into the
        placement heuristic instead of the window just observed (horizon 0
        passes the observed arrays through untouched, so decisions
        bit-reproduce the reactive pipeline). With prefetch on, a placement
        change is only STAGED here — (False, 0.0) is returned, the moving
        experts' weights start copying asynchronously, and the caller's
        :meth:`poll_prefetch` commits the flip once the copy lands."""
        if self.profiler.window_tokens < self.cfg.window_tokens:
            return False, 0.0
        B, A = self.profiler.snapshot(reset=True)
        self._last_B = B.astype(np.float64)
        if not self.cfg.rebalance:
            self._last_rank_load = self.placement.per_rank_load(self._last_B)
            return False, 0.0
        Bp, Ap = B, A
        if self.forecaster is not None:
            self.forecaster.observe(B, A)
            Bp, Ap = self.forecaster.predict(B, A)

        if self.prefetch_cost is not None:
            new_assign, plan = self.placement.solve(Bp, Ap)
            # until the flip lands, this window's traffic keeps hitting the
            # CURRENT placement — pressure signals must reflect that
            self._last_rank_load = self.placement.per_rank_load(self._last_B)
            if not plan:
                if self._pending is not None:
                    # the fresh forecast says "stay put": the in-flight
                    # prefetch is stale — drop it (bytes already wasted)
                    self.prefetch_misses += 1
                    self._pending = None
                return False, 0.0
            if self._pending is not None:
                if np.array_equal(self._pending["assign"], new_assign):
                    return False, 0.0   # same target, copy already in flight
                self.prefetch_misses += 1
            nbytes = self.prefetch_cost.bytes_for(len(plan))
            self.prefetch_bytes += nbytes
            self._pending = {
                "assign": new_assign, "plan": plan, "B": B,
                "ready": now + self.prefetch_cost.duration(nbytes)}
            if self.on_prefetch is not None:
                self.on_prefetch(
                    plan, self.placement.permutations_of(new_assign))
            return False, 0.0

        plan = self.placement.update(Bp, Ap)
        # pressure signals reflect the window's traffic under the placement
        # that will serve the NEXT window
        self._last_rank_load = self.placement.per_rank_load(self._last_B)
        if not plan:
            return False, 0.0
        dur = self.migration_duration(len(plan))
        self._migrated_once = True
        self.sync_migrations += 1
        self.sync_stall_s += dur
        self.migration_log.append(
            {"t": now, "moves": len(plan), "duration_s": dur})
        if self.on_migration is not None:
            self.on_migration(plan, self.placement.permutations())
        return True, dur

    def poll_prefetch(self, now: float) -> int:
        """Commit a staged placement whose weight prefetch has landed:
        the pointer flip. Returns the number of expert moves applied
        (0 when nothing is pending or the copy is still in flight) —
        these moves never stalled the serving path."""
        p = self._pending
        if p is None or now + 1e-12 < p["ready"]:
            return 0
        plan = self.placement.commit(p["assign"], p["plan"], p["B"])
        self._pending = None
        self._migrated_once = True
        self.prefetch_hits += 1
        self.migrations_hidden += len(plan)
        self._last_rank_load = self.placement.per_rank_load(self._last_B)
        self.migration_log.append(
            {"t": now, "moves": len(plan), "duration_s": self.cfg.flip_s,
             "hidden": True})
        if self.on_migration is not None:
            self.on_migration(plan, self.placement.permutations())
        return len(plan)

    def placement_signals(self) -> Dict:
        """Placement/forecast/prefetch telemetry for cluster signals —
        migration activity used to be invisible outside the coordinator."""
        f = self.forecaster
        return {
            "n_rebalances": self.placement.n_rebalances,
            "n_migrations": self.placement.n_migrations,
            "sync_migrations": self.sync_migrations,
            "sync_migration_stall_s": self.sync_stall_s,
            "migrations_hidden": self.migrations_hidden,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_misses": self.prefetch_misses,
            "prefetch_bytes": self.prefetch_bytes,
            "prefetch_pending": int(self._pending is not None),
            "forecast_mae": f.forecast_mae if f else 0.0,
            "forecast_naive_mae": f.naive_mae if f else 0.0,
            "forecast_windows": f.n_windows if f else 0,
            "forecast_fallbacks": f.fallback_windows if f else 0,
        }

    def migration_duration(self, n_moves: int) -> float:
        dur = self.cfg.migration_base_s \
            + self.cfg.migration_per_move_s * n_moves
        if not self._migrated_once:
            dur += self.cfg.migration_warmup_s
        return dur

    def engine_contention(self, engine_id: int) -> float:
        """Relative load of the engine's co-located EP ranks vs the fleet
        mean (>= 0 excess) — hot local ranks slow the co-located engine's
        attention/dense compute (paper §2.2.3)."""
        ranks = self.ranks_of_engine(engine_id)
        total = float(self._last_rank_load.sum())
        if not ranks or total <= 0:
            return 0.0
        mine = float(self._last_rank_load[:, ranks].sum())
        expect = total * len(ranks) / self.n_ranks
        return max(mine / max(expect, 1e-9) - 1.0, 0.0)

    # ---- feedback: backend MoE pressure -> DP traces --------------------
    def engine_moe_pressure(self, engine_id: int) -> float:
        """Token-equivalent pressure from the engine's co-located EP ranks:
        relative excess of its rank load vs the fleet mean (last window),
        scaled into token units so Algorithm 1 can sum it with prefill/queue
        pressure. Balanced backend => 0."""
        if not self.cfg.feedback:
            return 0.0
        ranks = self.ranks_of_engine(engine_id)
        if not ranks:
            return 0.0
        total = float(self._last_rank_load.sum())
        if total <= 0:
            return 0.0
        mine = float(self._last_rank_load[:, ranks].sum())
        expect = total * len(ranks) / self.n_ranks
        rel_excess = mine / max(expect, 1e-9) - 1.0
        return max(rel_excess, 0.0) * self.cfg.moe_pressure_norm

    def cross_dp_fraction(self, A: np.ndarray) -> float:
        """Fraction of routed tokens whose expert sits on a remote DP
        group's ranks under the current placement (Fig. 4 metric)."""
        total, remote = 0, 0.0
        D = self.placement.D
        for l in range(A.shape[0]):
            rank_of_e = self.placement.assign[l]
            for s in range(A.shape[1]):
                w = A[l, s]
                total += w.sum()
                remote += w[D[s, rank_of_e] > 0].sum()
        return float(remote) / max(float(total), 1.0)
