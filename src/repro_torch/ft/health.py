"""Engine health + straggler mitigation.

Detection: an engine whose trace stream goes silent past ``timeout_s`` is
marked unhealthy — the DP scheduler excludes it and its queued (not yet
running) requests are re-dispatched to healthy engines. This composes with
Algorithm 1's own behavior: a *slow* (straggling) engine keeps reporting
growing pressure, so pressure-aware dispatch starves it of new work long
before the hard timeout; the timeout handles full failures.
Recovery: a fresh trace re-admits the engine (elastic rejoin).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.scheduler import GimbalScheduler
from repro_torch.core.traces import TraceTable


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    trace_timeout_s: float = 2.0
    rejoin_on_fresh_trace: bool = True


class EngineHealthMonitor:
    def __init__(self, table: TraceTable, scheduler: GimbalScheduler,
                 cfg: HealthConfig = HealthConfig(),
                 redispatch: Optional[Callable] = None):
        self.table = table
        self.scheduler = scheduler
        self.cfg = cfg
        self.redispatch = redispatch      # fn(engine_id) -> requests to move
        self.unhealthy: Set[int] = set()
        self.events: List[Dict] = []

    def check(self, now: float) -> List[int]:
        """Returns engines newly marked unhealthy at ``now``."""
        newly = []
        stale = set(self.table.stale_engines(self.cfg.trace_timeout_s, now))
        for e in stale - self.unhealthy:
            self.unhealthy.add(e)
            self.scheduler.exclude(e)
            newly.append(e)
            moved = 0
            if self.redispatch is not None:
                moved = self.redispatch(e) or 0
            self.events.append({"t": now, "engine": e, "event": "down",
                                "requests_moved": moved})
        if self.cfg.rejoin_on_fresh_trace:
            for e in list(self.unhealthy):
                t = self.table.get(e)
                if t is not None and now - t.timestamp <= \
                        self.cfg.trace_timeout_s:
                    self.unhealthy.discard(e)
                    self.scheduler.include(e)
                    self.events.append({"t": now, "engine": e,
                                        "event": "rejoin"})
        return newly
