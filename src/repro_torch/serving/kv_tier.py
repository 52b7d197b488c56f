"""Host-memory KV page tier: swap instead of recompute, park cold prefixes.

The pool's only response to KV pressure used to be preempt-and-recompute.
This module adds the other half of the classic trade — "recompute the
prefill phase (compute-heavy) or reload KV from storage (I/O-heavy)" — as
a subsystem where KV state outlives device residency:

* :class:`HostKVTier` is a host-memory page store shared by every engine
  on a node (both planes use the same class, so Algorithm-1 signals
  agree). It holds two kinds of entries: whole-request page sets keyed by
  ``req_id`` (preemption/drain swap-out) and single archived pages keyed
  by an opaque handle (cold radix-indexed prefix pages parked off-device).
  Payloads are opaque to the tier — whatever the engine's ``save_pages``
  callback returns (host numpy copies on the real plane, ``None`` on the
  sim plane, which tracks only the accounting).

* :class:`TieredSharedAllocator` extends ``SharedPagedAllocator`` with
  explicit :meth:`~TieredSharedAllocator.swap_out_request` /
  :meth:`~TieredSharedAllocator.swap_in_request` (fp pages round-trip
  bit-exact through host memory), and *archiving*: when the pool would
  evict a reclaimable cached page, it can instead move the page's bytes
  to the tier and leave the radix node in place pointing at a **negative
  virtual id** — the prefix stays matchable while swapped, and a later
  admission match rematerializes it into a fresh device page without any
  recompute (``_attach_slot``).

Truthful accounting falls out of the design: swapped pages leave the
pool's books entirely, so ``free_blocks``/``kv_usage`` count *device-
resident* pages only — the scheduler's KV-pressure signals never charge
an engine for bytes already off-device. ``swapped_tokens`` is the new
per-engine signal for state parked in the tier.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.serving.paged import SharedPagedAllocator, _RadixNode

# save_pages(page_ids) -> payload; load_pages(payload, page_ids) -> None.
# The allocator never inspects payloads: bit-exactness is the callback
# pair's contract (engine_util/paged_engine gather device pages to host
# numpy and scatter them back).
SavePagesFn = Callable[[List[int]], Any]
LoadPagesFn = Callable[[Any, List[int]], None]


@dataclasses.dataclass(frozen=True)
class SwapRecord:
    """One tier transfer: planner decision record + step-plan op.

    ``kind`` is ``"out"`` (device -> host at preemption/drain) or ``"in"``
    (host -> device at re-admission). Transfers execute synchronously at
    decision time (the pages involved may be recycled within the same
    planning pass — same reason COW copies apply at plan time); the
    records ride :class:`~repro.serving.step_plan.StepPlan` for pricing,
    telemetry and invariant checks.
    """

    kind: str
    req_id: int
    n_pages: int
    tokens: int
    nbytes: int


@dataclasses.dataclass
class _TierEntry:
    payload: Any
    n_pages: int
    tokens: int
    nbytes: int


class HostKVTier:
    """Host-memory page store shared across a node's engines.

    ``capacity_pages=0`` means unbounded (host RAM is the real bound and
    is orders of magnitude larger than device pools); a positive value
    caps resident tier pages so tests can exercise tier-full fallbacks.
    ``page_nbytes`` is the per-page transfer size engines report for
    byte-accounting (it depends on the device page layout and dtype, so
    the engine that owns the arrays sets it).
    """

    def __init__(self, capacity_pages: int = 0, page_nbytes: int = 0):
        self.capacity_pages = capacity_pages
        self.page_nbytes = page_nbytes
        self._requests: Dict[int, _TierEntry] = {}
        self._pages: Dict[int, _TierEntry] = {}
        self._next_handle = 1
        self.stat_out_pages = 0
        self.stat_in_pages = 0
        self.stat_out_bytes = 0
        self.stat_in_bytes = 0
        self.stat_dropped_pages = 0

    # ---- capacity --------------------------------------------------------
    @property
    def pages_used(self) -> int:
        return (sum(e.n_pages for e in self._requests.values())
                + len(self._pages))

    def can_store(self, n_pages: int) -> bool:
        if self.capacity_pages <= 0:
            return True
        return self.pages_used + n_pages <= self.capacity_pages

    @property
    def swapped_tokens(self) -> int:
        """Total tokens of request state resident in the tier (all engines)."""
        return sum(e.tokens for e in self._requests.values())

    # ---- whole-request entries (swap-out / swap-in) ----------------------
    def put_request(self, req_id: int, payload: Any, *, n_pages: int,
                    tokens: int, nbytes: int) -> None:
        assert req_id not in self._requests, "request already swapped"
        self._requests[req_id] = _TierEntry(payload, n_pages, tokens, nbytes)
        self.stat_out_pages += n_pages
        self.stat_out_bytes += nbytes

    def holds_request(self, req_id: int) -> bool:
        return req_id in self._requests

    def peek_request(self, req_id: int) -> Optional[_TierEntry]:
        return self._requests.get(req_id)

    def take_request(self, req_id: int) -> _TierEntry:
        e = self._requests.pop(req_id)
        self.stat_in_pages += e.n_pages
        self.stat_in_bytes += e.nbytes
        return e

    def drop_request(self, req_id: int) -> bool:
        """Discard a swapped request's pages (quarantine/cancel path)."""
        e = self._requests.pop(req_id, None)
        if e is not None:
            self.stat_dropped_pages += e.n_pages
        return e is not None

    # ---- single archived pages (parked prefix pages) ---------------------
    def archive_page(self, payload: Any, nbytes: int) -> int:
        """Store one page; returns a handle >= 1 (allocators index the
        page under the negative of this handle)."""
        h = self._next_handle
        self._next_handle += 1
        self._pages[h] = _TierEntry(payload, 1, 0, nbytes)
        self.stat_out_pages += 1
        self.stat_out_bytes += nbytes
        return h

    def has_page(self, handle: int) -> bool:
        return handle in self._pages

    def take_page(self, handle: int) -> _TierEntry:
        e = self._pages.pop(handle)
        self.stat_in_pages += 1
        self.stat_in_bytes += e.nbytes
        return e

    def drop_page(self, handle: int) -> None:
        if self._pages.pop(handle, None) is not None:
            self.stat_dropped_pages += 1


class TieredSharedAllocator(SharedPagedAllocator):
    """Prefix-sharing allocator with a host tier behind it.

    Three behaviors on top of :class:`SharedPagedAllocator`:

    * **swap-out / swap-in** of whole requests: gather the block table's
      pages to the tier, free the device pages (the request keeps its
      ``prefill_done``/``generated`` progress), then later restore into
      freshly allocated pages — no recompute, bit-exact on fp pages;
    * **archiving**: ``_take_page`` under pressure moves the LRU cached
      page's bytes to the tier instead of discarding them, leaving the
      radix node pointing at a negative virtual id so the prefix stays
      matchable. ``_attach_slot`` rematerializes on match;
    * **truthful books**: swapped and archived pages are *not* counted in
      ``free_blocks``/``kv_usage`` — only device-resident state is.

    Passing ``save_pages=None`` (sim plane) stores ``None`` payloads:
    all the accounting, none of the bytes.
    """

    def __init__(self, n_pages: int, page_size: int = 16, *,
                 tier: HostKVTier,
                 save_pages: Optional[SavePagesFn] = None,
                 load_pages: Optional[LoadPagesFn] = None,
                 archive_prefixes: bool = True):
        super().__init__(n_pages, page_size)
        self.tier = tier
        self._save: SavePagesFn = save_pages or (lambda ids: None)
        self._load: LoadPagesFn = load_pages or (lambda payload, ids: None)
        self.archive_prefixes = archive_prefixes
        # req_id -> tokens swapped out *by this allocator* (the per-engine
        # share of the tier's total; pruned lazily as peers swap them in)
        self._swapped: Dict[int, int] = {}
        self.stat_archived_pages = 0
        self.stat_revived_pages = 0
        self.stat_swapped_out_reqs = 0
        self.stat_swapped_in_reqs = 0

    # ---- request swap ----------------------------------------------------
    def swap_out_request(self, req_id: int, tokens: int) \
            -> Optional[SwapRecord]:
        """Move ``req_id``'s pages to the tier and free them on-device.
        Returns the transfer record, or None when the request holds no
        pages or the tier is full (caller falls back to recompute)."""
        table = self.tables.get(req_id)
        if not table or self.tier.holds_request(req_id):
            return None
        n = len(table)
        if not self.tier.can_store(n):
            return None
        payload = self._save(list(table))
        nbytes = n * self.tier.page_nbytes
        self.tier.put_request(req_id, payload, n_pages=n, tokens=tokens,
                              nbytes=nbytes)
        self.free(req_id)
        self._swapped[req_id] = tokens
        self.stat_swapped_out_reqs += 1
        return SwapRecord("out", req_id, n, tokens, nbytes)

    def swap_in_request(self, req_id: int) -> Optional[SwapRecord]:
        """Restore a swapped request into freshly allocated device pages.
        Returns None (books untouched, entry kept) when the pool cannot
        back the pages — the caller retries later or recomputes."""
        ent = self.tier.peek_request(req_id)
        if ent is None:
            return None
        assert not self.tables.get(req_id), "swap-in over a live table"
        n = ent.n_pages
        if self.force_alloc_fail or n > self.free_blocks:
            return None
        pages = []
        for _ in range(n):
            p = self._take_page()
            self.refcount[p] = 1
            pages.append(p)
        self.tables[req_id] = pages
        self.free_blocks -= n
        self._held[req_id] = n
        self.stat_blocks_allocated += n
        ent = self.tier.take_request(req_id)
        self._load(ent.payload, pages)
        self._swapped.pop(req_id, None)
        self.stat_swapped_in_reqs += 1
        return SwapRecord("in", req_id, n, ent.tokens, ent.nbytes)

    def holds_swapped(self, req_id: int) -> bool:
        return self.tier.holds_request(req_id)

    def drop_swapped(self, req_id: int) -> bool:
        """Discard a swapped request's tier entry (quarantine/cancel)."""
        self._swapped.pop(req_id, None)
        return self.tier.drop_request(req_id)

    @property
    def swapped_tokens(self) -> int:
        """Tokens this engine swapped out that are still in the tier."""
        stale = [rid for rid in self._swapped
                 if not self.tier.holds_request(rid)]
        for rid in stale:
            del self._swapped[rid]
        return sum(self._swapped.values())

    # ---- archiving (cold prefix pages park off-device) -------------------
    def _take_page(self) -> int:
        if self._free_ids:
            return self._free_ids.pop()
        if self.archive_prefixes and self.tier.can_store(1):
            # move the LRU cached page's bytes to the tier instead of
            # discarding them: the radix node stays, repointed at a
            # negative virtual id, so the prefix remains matchable and a
            # later hit rematerializes it without recompute
            for p in self._cached:                # insertion order == LRU
                node = self._page_node[p]
                payload = self._save([p])
                h = self.tier.archive_page(payload,
                                           nbytes=self.tier.page_nbytes)
                del self._cached[p]
                del self._page_node[p]
                node.page = -h
                self._page_node[-h] = node
                self.stat_archived_pages += 1
                return p
        return super()._take_page()

    def _evict(self, node: _RadixNode) -> None:
        """Eviction must also drop the tier entries of any archived
        (virtual-id) pages in the doomed subtree, or host capacity leaks."""
        virt, stack = [], [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children)
            if n.page < 0:
                virt.append(-n.page)
        super()._evict(node)
        for h in virt:
            self.tier.drop_page(h)

    def _attach_slot(self, node: _RadixNode) -> Optional[int]:
        """Attach one matched slot, rematerializing archived pages.

        Rematerialization calls ``_take_page``, which may archive or
        evict *other* cached pages — including nodes memoized for later
        slots of the same match. The identity check guards against that:
        a node no longer indexed under its page was recycled mid-match,
        so the match truncates (``None``) instead of attaching stale or
        foreign content. Earlier slots are safe — once attached their
        refcount is >= 1, so they are neither cached nor evictable.
        """
        p = node.page
        if p >= 0:
            if self._page_node.get(p) is not node:
                return None           # evicted by an earlier slot's revive
            return super()._attach_slot(node)
        if self._page_node.get(p) is not node:
            return None
        if self.force_alloc_fail or self.free_blocks == 0:
            return None
        phys = self._take_page()
        self.refcount[phys] = 1
        self.free_blocks -= 1
        ent = self.tier.take_page(-p)
        self._load(ent.payload, [phys])
        del self._page_node[p]
        node.page = phys
        self._page_node[phys] = node
        self.stat_revived_pages += 1
        return phys

    # ---- teardown --------------------------------------------------------
    def drop_index(self) -> None:
        """Evict the whole radix index, dropping archived tier handles.

        Crash/reset teardown: the index dies with the pool, so parked
        prefix pages become unreachable and must not leak host capacity.
        Request-level tier entries are *kept* — their payloads were
        copied to host before the crash and re-attach on any engine
        sharing the tier."""
        for c in list(self._root.children):
            cached_own = c.page in self._cached
            self._evict(c)         # _evict leaves the root page to caller
            if cached_own:
                self._free_ids.append(c.page)

    # ---- invariants ------------------------------------------------------
    def check_invariants(self) -> None:
        super().check_invariants()
        for vid, node in self._page_node.items():
            if vid < 0:
                assert self.tier.has_page(-vid), \
                    "archived page lost its tier entry"
                assert node.page == vid
        for rid in self.tables:
            assert not self.tier.holds_request(rid), \
                "request both device-resident and swapped"
        for rid in self._swapped:
            assert rid not in self.tables
