"""Runtime trace collection (paper §4.1).

Each backend DP engine periodically and asynchronously reports a compact
trace: remaining prefill tokens of running requests, waiting prefill tokens
in the local queue, KV-cache usage, and backend MoE expert pressure. The
scheduler always reads the *latest available* trace (never blocks request
admission on freshness) and relies on the compensation term (scheduler.py)
to bridge staleness — exactly the paper's async design.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Set, Tuple, Union


@dataclasses.dataclass(frozen=True)
class PrefixSummary:
    """Compact digest of one engine's prefix cache (the radix tree in
    ``serving/paged.py``), shipped on every trace so Algorithm 1 can score
    *cache affinity*: fingerprints of each distinct root-level first page
    (or shorter leaf path, for trees shallower than one page) map to the
    deepest matchable token depth beneath it. A handful of ints per
    distinct cached system prompt — never the tokens themselves.

    The estimate is intentionally one-sided cheap: a fingerprint hit may
    overestimate (the query can diverge below the first page) and a query
    shorter than every indexed first page estimates 0. Both are fine for a
    scheduling *credit* — admission still calls ``match_prefix`` for the
    exact token-granular attach, so correctness never depends on this.
    """

    block_size: int
    entries: Dict[int, int] = dataclasses.field(default_factory=dict)
    indexed_tokens: int = 0                 # total tokens in the tree
    # the allocator's monotone index-mutation counter at digest time:
    # deltas chain on it (apply only when base_version matches)
    version: int = 0

    def estimate_hit_tokens(self, tokens: Sequence) -> int:
        """Estimated cache-hit tokens were ``tokens`` dispatched to this
        engine: deepest indexed depth under the longest fingerprinted
        prefix of the first page, capped at the prompt length."""
        if not self.entries or not tokens:
            return 0
        for n in range(min(self.block_size, len(tokens)), 0, -1):
            depth = self.entries.get(hash(tuple(tokens[:n])), 0)
            if depth:
                return min(depth, len(tokens))
        return 0

    def apply(self, delta: "PrefixSummaryDelta") -> "PrefixSummary":
        """Reconstruct the successor full digest from a delta whose
        ``base_version`` matches this summary's ``version``."""
        assert delta.base_version == self.version, "delta chain broken"
        entries = dict(self.entries)
        for k in delta.removed:
            entries.pop(k, None)
        entries.update(delta.updates)
        return PrefixSummary(block_size=delta.block_size, entries=entries,
                             indexed_tokens=delta.indexed_tokens,
                             version=delta.version)


@dataclasses.dataclass(frozen=True)
class PrefixSummaryDelta:
    """Incremental prefix-cache digest: only the fingerprints that changed
    since the engine's previously shipped summary. Trees mutate rarely
    relative to the trace cadence (most traces ship an empty delta), so
    this is what rides ``EngineTrace.prefix_summary`` in steady state —
    the :class:`TraceTable` folds deltas back into full summaries for the
    scheduler, requesting a full-digest resync whenever the version chain
    breaks (missed trace, engine restart, scheduler ``include()``)."""

    block_size: int
    base_version: int                       # full digest this applies to
    version: int                            # digest version after applying
    updates: Dict[int, int] = dataclasses.field(default_factory=dict)
    removed: Tuple[int, ...] = ()
    indexed_tokens: int = 0


def diff_prefix_summary(prev: PrefixSummary,
                        cur: PrefixSummary) -> PrefixSummaryDelta:
    """Delta such that ``prev.apply(delta) == cur``."""
    updates = {k: v for k, v in cur.entries.items()
               if prev.entries.get(k) != v}
    removed = tuple(k for k in prev.entries if k not in cur.entries)
    return PrefixSummaryDelta(block_size=cur.block_size,
                              base_version=prev.version,
                              version=cur.version, updates=updates,
                              removed=removed,
                              indexed_tokens=cur.indexed_tokens)


@dataclasses.dataclass
class EngineTrace:
    """One engine's compact runtime state (a handful of scalars)."""

    engine_id: int
    remaining_prefill_tokens: float = 0.0   # unfinished prefill of RUNNING reqs
    waiting_prefill_tokens: float = 0.0     # prefill tokens queued locally
    kv_usage: float = 0.0                   # fraction of KV budget in use [0,1]
    moe_pressure: float = 0.0               # normalized token-equivalent expert
                                            # load on this engine's EP ranks
    n_running: int = 0
    n_waiting: int = 0
    n_stalled: int = 0                      # decode lanes stalled last step:
                                            # KV growth failed even after
                                            # preemption (hard KV pressure)
    swap_in_blocked: float = 0.0            # head-of-line swap-ins the pool
                                            # could not back last step —
                                            # tier pressure, distinct from
                                            # an ordinary full-pool stall
    # tiered-KV signals (kv_tier.py; 0 when the engine has no tier):
    # tokens of this engine's requests parked in the host tier — state
    # that is NOT in kv_usage, which truthfully counts device-resident
    # pages only — and host->device bytes restored since the last trace
    swapped_tokens: float = 0.0
    swap_in_bytes: float = 0.0
    # radix prefix-cache digest (None when the engine doesn't share):
    # a full PrefixSummary on first report / resync, a PrefixSummaryDelta
    # in steady state — TraceTable.report folds deltas into the stored
    # full digest, so scheduler reads always see a full summary. Treated
    # as immutable, so copy() sharing the object is sound.
    prefix_summary: Union[PrefixSummary, PrefixSummaryDelta, None] = None
    timestamp: float = 0.0

    def copy(self) -> "EngineTrace":
        return dataclasses.replace(self)


class TraceTable:
    """Latest-trace store, written by engines, read by the DP scheduler."""

    def __init__(self, engine_ids):
        self._traces: Dict[int, Optional[EngineTrace]] = {
            e: None for e in engine_ids}
        self._resync: Set[int] = set()     # engines owing a full digest
        # last FULL digest received per engine: engines diff every delta
        # against the last full digest they shipped (idempotent emission),
        # so this — not the delta-applied reconstruction — is the base
        self._delta_base: Dict[int, PrefixSummary] = {}

    @property
    def engine_ids(self):
        return list(self._traces.keys())

    def report(self, trace: EngineTrace, now: Optional[float] = None) -> None:
        trace.timestamp = time.time() if now is None else now
        s = trace.prefix_summary
        if isinstance(s, PrefixSummaryDelta):
            base = self._delta_base.get(trace.engine_id)
            if trace.engine_id not in self._resync and base is not None \
                    and base.version == s.base_version:
                trace.prefix_summary = base.apply(s)
            else:
                # broken chain (fresh table, restarted engine, unknown
                # base): keep the last known full reconstruction — stale
                # but valid for a scheduling credit — and ask the engine
                # for a full resync on its next trace
                prev = self._traces.get(trace.engine_id)
                stale = prev.prefix_summary if prev is not None else None
                trace.prefix_summary = stale \
                    if isinstance(stale, PrefixSummary) else None
                self._resync.add(trace.engine_id)
        elif isinstance(s, PrefixSummary):
            self._delta_base[trace.engine_id] = s
            self._resync.discard(trace.engine_id)
        self._traces[trace.engine_id] = trace

    def needs_resync(self, engine_id: int) -> bool:
        """True when this engine's next trace must carry a full digest
        (never reported, chain broken, or a resync was requested)."""
        return engine_id in self._resync \
            or self._traces.get(engine_id) is None

    def request_resync(self, engine_id: int) -> None:
        """Force the next trace to ship a full digest (scheduler
        ``include()`` after exclusion, engine restart, elastic rejoin)."""
        self._resync.add(engine_id)

    def get(self, engine_id: int) -> Optional[EngineTrace]:
        return self._traces.get(engine_id)

    def complete(self) -> bool:
        """True once every engine has reported at least once (Alg. 1 line 1)."""
        return all(t is not None for t in self._traces.values())

    def snapshot(self) -> Dict[int, EngineTrace]:
        return {e: t.copy() for e, t in self._traces.items() if t is not None}

    def scalar_snapshot(self) -> Dict[int, Dict[str, float]]:
        """JSON-serializable scalar view of the latest traces (prefix
        summaries omitted — the resync path rebuilds those from the live
        engines). Feeds serving-state checkpoints, so a restarted control
        plane resumes with pressure signals instead of fallback dispatch."""
        out: Dict[int, Dict[str, float]] = {}
        for e, t in self._traces.items():
            if t is None:
                continue
            out[int(e)] = {
                "remaining_prefill_tokens": float(t.remaining_prefill_tokens),
                "waiting_prefill_tokens": float(t.waiting_prefill_tokens),
                "kv_usage": float(t.kv_usage),
                "moe_pressure": float(t.moe_pressure),
                "n_running": int(t.n_running),
                "n_waiting": int(t.n_waiting),
                "n_stalled": int(t.n_stalled),
                "swap_in_blocked": float(t.swap_in_blocked),
                "swapped_tokens": float(t.swapped_tokens),
                "swap_in_bytes": float(t.swap_in_bytes),
                "timestamp": float(t.timestamp),
            }
        return out

    def restore_scalars(self, snap: Dict) -> None:
        """Seed the table from :meth:`scalar_snapshot` output (restored
        engines owe a full prefix-summary resync on their next trace)."""
        for e, s in snap.items():
            e, s = int(e), dict(s)
            ts = float(s.pop("timestamp", 0.0))
            self._traces[e] = EngineTrace(engine_id=e, timestamp=ts, **s)
            self._resync.add(e)

    def add_engine(self, engine_id: int) -> None:
        """Elastic scale-up: new engine starts with no trace (ordered dispatch
        covers it until its first report)."""
        self._traces.setdefault(engine_id, None)
        self._resync.add(engine_id)        # no base to chain deltas onto

    def remove_engine(self, engine_id: int) -> None:
        self._traces.pop(engine_id, None)
        self._resync.discard(engine_id)
        self._delta_base.pop(engine_id, None)

    def stale_engines(self, timeout_s: float, now: Optional[float] = None):
        """Engines whose last report is older than ``timeout_s`` (health /
        straggler detection — see serving/health.py)."""
        now = time.time() if now is None else now
        out = []
        for e, t in self._traces.items():
            if t is not None and now - t.timestamp > timeout_s:
                out.append(e)
        return out
