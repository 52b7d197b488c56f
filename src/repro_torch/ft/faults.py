"""Deterministic fault injection for the real-plane cluster.

A :class:`FaultPlan` is a declarative, seed-reproducible chaos schedule —
"engine 1 crashes at round 40 and recovers at round 90, engine 0's traces
drop for rounds 55..58, engine 2's allocator fails for a 6-round burst" —
that ``serve_real_cluster`` consults once per virtual round through a
:class:`FaultInjector`. Because cluster time is virtual and decode is
deterministic, any plan is a *reproducible test case*: the chaos property
harness (tests/test_faults.py) replays random plans and asserts the
recovery invariants (no request lost or duplicated, every non-quarantined
request finishes, outputs bit-exact vs the fault-free run).

Fault taxonomy (``FaultEvent.kind``):

* ``crash``      — the engine's KV pool is lost at ``round``; its resident
                   and queued requests are exported for re-dispatch
                   (``PagedRealEngine.fail``). The control plane learns of
                   the death only via trace staleness (EngineHealthMonitor).
* ``recover``    — a dead engine restarts at ``round`` with a fresh, empty
                   pool; a fresh trace re-admits it (elastic rejoin).
* ``drain``      — graceful scale-in: stop admitting at ``round``, export
                   the local queue, finish residents, then release the pool
                   and leave the fleet.
* ``trace_drop`` — the engine's trace reports are lost for rounds
                   [round, round+duration]; past the health timeout the
                   cluster *fences* the silent engine (presumed dead IS
                   dead — re-dispatching its work while it still ran would
                   duplicate requests).
* ``slow``       — straggler: the engine steps only once every ``period``
                   rounds inside the window but keeps reporting (growing)
                   pressure, so Algorithm 1 starves it of new work.
* ``alloc_fail`` — the engine's page allocator fails every allocation
                   inside the window (device memory fault burst); requests
                   stall or are preempted-for-recompute, never corrupted.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

KINDS = ("crash", "recover", "drain", "trace_drop", "slow", "alloc_fail")
_POINT = ("crash", "recover", "drain")          # fire once, at `round`
_WINDOW = ("trace_drop", "slow", "alloc_fail")  # active rounds [round, round+duration]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    engine_id: int
    round: int                # first cluster round the fault applies
    duration: int = 0         # windowed kinds stay active this many extra rounds
    period: int = 2           # slow: the engine steps once every `period` rounds

    def __post_init__(self):
        assert self.kind in KINDS, f"unknown fault kind {self.kind!r}"
        assert self.round >= 0 and self.duration >= 0 and self.period >= 1


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, immutable chaos schedule (sortable, hashable, diffable)."""

    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None         # provenance only (random plans)

    @classmethod
    def random(cls, seed: int, n_engines: int, *, horizon_rounds: int = 120,
               detect_rounds: int = 8, n_windows: Optional[int] = None
               ) -> "FaultPlan":
        """Seed-reproducible random plan over ``n_engines``.

        Engine 0 is the *anchor*: never crashed or drained, and any trace
        drop on it stays below the detection window — so re-dispatch always
        has a live target and every non-quarantined request can finish.
        Crashes get a recovery most of the time (rejoin is part of the
        property being tested); windowed faults are finite bursts.
        """
        assert n_engines >= 1
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        lo = max(horizon_rounds // 8, 2)
        for e in range(1, n_engines):
            roll = rng.random()
            if roll < 0.5:                                   # crash (+rejoin)
                r0 = int(rng.integers(lo, max(horizon_rounds // 2, lo + 1)))
                events.append(FaultEvent("crash", e, r0))
                if rng.random() < 0.75:
                    gap = int(rng.integers(detect_rounds + 2,
                                           detect_rounds + horizon_rounds // 2))
                    events.append(FaultEvent("recover", e, r0 + gap))
            elif roll < 0.7:                                 # graceful drain
                events.append(FaultEvent(
                    "drain", e,
                    int(rng.integers(lo, max(horizon_rounds // 2, lo + 1)))))
        n_win = int(rng.integers(1, 4)) if n_windows is None else n_windows
        for _ in range(n_win):
            e = int(rng.integers(0, n_engines))
            kind = str(rng.choice(_WINDOW))
            if kind == "trace_drop" and e == 0:
                dur = int(rng.integers(1, max(detect_rounds - 2, 2)))
            else:
                dur = int(rng.integers(2, 12))
            events.append(FaultEvent(
                kind, e, int(rng.integers(0, horizon_rounds)), duration=dur,
                period=int(rng.integers(2, 5))))
        events.sort(key=lambda ev: (ev.round, ev.engine_id, ev.kind))
        return cls(events=tuple(events), seed=seed)


class FaultInjector:
    """Per-round oracle over a :class:`FaultPlan` (pure, deterministic)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._at: Dict[int, List[FaultEvent]] = defaultdict(list)
        self._windows: Dict[Tuple[str, int], List[FaultEvent]] = \
            defaultdict(list)
        for ev in plan.events:
            if ev.kind in _POINT:
                self._at[ev.round].append(ev)
            else:
                self._windows[(ev.kind, ev.engine_id)].append(ev)

    def _point(self, kind: str, rnd: int) -> List[int]:
        return [ev.engine_id for ev in self._at.get(rnd, ())
                if ev.kind == kind]

    def crashes(self, rnd: int) -> List[int]:
        return self._point("crash", rnd)

    def recoveries(self, rnd: int) -> List[int]:
        return self._point("recover", rnd)

    def drains(self, rnd: int) -> List[int]:
        return self._point("drain", rnd)

    def _window(self, kind: str, engine_id: int, rnd: int
                ) -> Optional[FaultEvent]:
        for ev in self._windows.get((kind, engine_id), ()):
            if ev.round <= rnd <= ev.round + ev.duration:
                return ev
        return None

    def drop_trace(self, engine_id: int, rnd: int) -> bool:
        return self._window("trace_drop", engine_id, rnd) is not None

    def alloc_fail(self, engine_id: int, rnd: int) -> bool:
        return self._window("alloc_fail", engine_id, rnd) is not None

    def skip_step(self, engine_id: int, rnd: int) -> bool:
        """Straggler: inside a ``slow`` window the engine steps only on
        every ``period``-th round (phase-locked to the window start)."""
        ev = self._window("slow", engine_id, rnd)
        return ev is not None and (rnd - ev.round) % ev.period != 0
