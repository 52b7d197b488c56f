"""Elastic DP-engine scaling.

The engine set is dynamic: scale-up registers a new engine in the trace
table (ordered-dispatch covers it until its first report — Algorithm 1's
fallback already handles partially-known fleets); scale-down drains an
engine (no new dispatch, requests re-routed) then removes it. The expert
placement manager re-solves when the EP-rank set changes, since the
source->rank distance matrix changes shape.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.coordinator import GimbalCoordinator
from repro_torch.core.placement import (PlacementManager,
                                  default_distance_matrix)
from repro_torch.core.scheduler import GimbalScheduler
from repro_torch.core.traces import TraceTable


class ElasticController:
    def __init__(self, table: TraceTable, scheduler: GimbalScheduler,
                 coordinator: Optional[GimbalCoordinator] = None,
                 ranks_per_engine: int = 2):
        self.table = table
        self.scheduler = scheduler
        self.coord = coordinator
        self.ranks_per_engine = ranks_per_engine
        self.log: List[Dict] = []

    def scale_up(self, engine_id: int, now: float = 0.0) -> None:
        self.table.add_engine(engine_id)
        self.scheduler.include(engine_id)
        self._rebuild_placement(now)
        self.log.append({"t": now, "event": "scale_up",
                         "engine": engine_id})

    def scale_down(self, engine_id: int, now: float = 0.0,
                   drain: Optional[Callable] = None,
                   swapped: int = 0) -> None:
        self.scheduler.exclude(engine_id)      # stop new dispatch first
        moved = drain(engine_id) if drain is not None else 0
        self.table.remove_engine(engine_id)
        self._rebuild_placement(now)
        entry = {"t": now, "event": "scale_down",
                 "engine": engine_id, "requests_moved": moved}
        if swapped:
            # residents exported through the KV tier with progress intact
            # (kv_tier.py): re-dispatch re-attaches pages, no recompute
            entry["swapped_requests"] = swapped
        self.log.append(entry)

    def _rebuild_placement(self, now: float) -> None:
        if self.coord is None:
            return
        n_eng = len(self.table.engine_ids)
        n_ranks = max(n_eng * self.ranks_per_engine, 1)
        old = self.coord.placement
        self.coord.n_engines = n_eng
        self.coord.n_ranks = n_ranks
        self.coord.placement = PlacementManager(
            old.L, old.E, n_ranks, n_eng, cfg=old.cfg,
            D=default_distance_matrix(n_eng, n_ranks))
        self.coord._last_rank_load = np.zeros((max(old.L, 1), n_ranks))
        self.coord.profiler.snapshot(reset=True)   # stats no longer comparable
