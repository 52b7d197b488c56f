"""Helpers shared by the serving engines (simulated, real, paged).

Centralised so the engines cannot silently diverge on: (B, A) stats-window
draining for the coordinator, preemption victim selection, and the
prefix-sharing admission / allocate+COW growth steps.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request


def drain_window_stats(stats_log: List[dict]):
    """Sum and clear accumulated per-step MoE stats -> (B, A) numpy arrays
    for the coordinator's profiler, or (None, None) if nothing accrued."""
    if not stats_log:
        return None, None
    B = sum(s["expert_counts"] for s in stats_log)
    A = sum(s["source_expert"] for s in stats_log)
    stats_log.clear()
    return np.asarray(B), np.asarray(A)


class PrefixSummaryShipper:
    """Delta transport for the radix prefix digest, shared by the real and
    simulated engines: the full summary DFS runs only when the allocator's
    ``summary_version`` moved, a full digest ships on the first emit or a
    requested resync, and every other trace carries a cheap
    :class:`~repro.core.traces.PrefixSummaryDelta` (usually tiny — trees
    mutate rarely relative to the trace cadence).

    Deltas are diffed against the last FULL digest shipped, not the last
    emit, so ``emit`` is idempotent: a trace that never reaches the
    :class:`~repro.core.traces.TraceTable` (an extra monitoring read, a
    dropped report) cannot break the version chain — the next delivered
    delta still applies to the table's stored base. The shipper re-bases
    (ships a fresh full digest) once the delta outgrows half the digest,
    bounding steady-state delta size.

    When the pool exposes ``consume_summary_changes`` (the incremental
    radix digest), the shipper accumulates the changed-key set since the
    last re-base and builds deltas by probing only those keys —
    O(changes) per trace instead of an O(digest) full diff, which is what
    keeps million-request session workloads (trees with thousands of
    distinct root prompts, mutating every trace) from going quadratic."""

    def __init__(self, pool):
        self.pool = pool
        self._cached = None       # last computed full digest
        self._base = None         # last FULL digest shipped (delta base)
        # agg keys changed since the last re-base; None = pool has no
        # changelog, fall back to full diffs
        self._changed = set() \
            if hasattr(pool, "consume_summary_changes") else None

    def emit(self, full: bool = False):
        if self._cached is None \
                or self._cached.version != self.pool.summary_version:
            self._cached = self.pool.prefix_summary()
            if self._changed is not None:
                self._changed |= self.pool.consume_summary_changes()
        cur = self._cached
        if full or self._base is None:
            self._base = cur
            if self._changed is not None:
                self._changed = set()
            return cur
        from repro_torch.core.traces import (PrefixSummaryDelta,
                                       diff_prefix_summary)
        if self._changed is None:
            delta = diff_prefix_summary(self._base, cur)
        else:
            base_e, cur_e = self._base.entries, cur.entries
            updates, removed = {}, []
            for k in self._changed:
                v = cur_e.get(k)
                if v is None:
                    if k in base_e:
                        removed.append(k)
                elif base_e.get(k) != v:
                    updates[k] = v
            delta = PrefixSummaryDelta(block_size=cur.block_size,
                                       base_version=self._base.version,
                                       version=cur.version,
                                       updates=updates,
                                       removed=tuple(removed),
                                       indexed_tokens=cur.indexed_tokens)
        if 2 * (len(delta.updates) + len(delta.removed)) \
                > max(len(cur.entries), 1):
            self._base = cur      # re-base: the delta is no longer cheap
            if self._changed is not None:
                self._changed = set()
            return cur
        return delta


def match_prefix_on_admit(pool, req: Request) -> int:
    """Prefix-cache admission step shared by DPEngine and PagedRealEngine:
    attach the longest cached prefix — token-granular under the radix
    index, so partial-page and mid-page hits count — and skip prefill past
    it, always leaving at least the last prompt token to recompute,
    because its logits seed the first sampled token. Returns the matched
    token count (0 when the request resumed mid-prefill or carries no
    tokens)."""
    if req.prefill_done != 0 or not req.prompt_tokens:
        return 0
    matched = pool.match_prefix(req.req_id, req.prompt_tokens)
    req.prefill_done = min(matched, req.prompt_len - 1)
    return matched


def release_prefix_match(pool, req: Request) -> None:
    """Undo a match when admission fails afterwards: a request sitting in
    the waiting queue must not pin shared pages — nor count phantom
    cache-hit tokens for prefill it never skipped (it will re-match on
    every admission retry)."""
    pool.release_match(req.req_id)
    req.prefill_done = 0


def grow_with_cow(pool, req: Request, need_tokens: int, write_lo: int,
                  write_hi: int, *, sharing: bool, preempt_one,
                  apply_copies=None) -> bool:
    """Back the next KV write, identically for the real and simulated
    engines: allocate pages to cover ``need_tokens``, then (under sharing)
    copy-on-write-protect tokens [write_lo, write_hi). Both stages preempt
    peers under pressure via ``preempt_one(req)``. ``apply_copies``
    receives the physical (src, dst) page pairs — None for the simulator,
    which only needs the accounting. False means the caller must stall."""
    ok = pool.allocate(req.req_id, need_tokens)
    while not ok and preempt_one(req):
        ok = pool.allocate(req.req_id, need_tokens)
    if not ok or not sharing:
        return ok
    cw = pool.prepare_write(req.req_id, write_lo, write_hi)
    while cw is None and preempt_one(req):
        cw = pool.prepare_write(req.req_id, write_lo, write_hi)
    if cw is None:
        return False
    if cw and apply_copies is not None:
        apply_copies(cw)
    return True


def select_preemption_victim(running: List[Request],
                             protect: Optional[Request] = None
                             ) -> Optional[Request]:
    """vLLM recompute-mode victim: the latest-arrived decode-phase request
    (any phase as fallback), never ``protect`` — evicting the request whose
    own growth triggered the eviction would trade progress for recompute."""
    cands = [r for r in running
             if r.remaining_prefill == 0 and r is not protect]
    if not cands:
        cands = [r for r in running if r is not protect]
    if not cands:
        return None
    return max(cands, key=lambda r: r.arrival_time)
