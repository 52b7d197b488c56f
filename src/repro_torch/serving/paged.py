"""Physical paged KV allocator: block tables + free-list on BlockPool books.

``PagedBlockAllocator`` extends the control-plane ``BlockPool`` (the thing
``kv_usage`` traces and Algorithm 1's KV-protection path read) with the
physical side: a free-list of page ids and per-request block tables. The
accounting invariant — ``free_blocks == len(free page ids)`` — makes the
scheduler's ``kv_usage`` signal the *actual* allocator state of the data
plane, not a parallel estimate.

``SharedPagedAllocator`` adds prefix sharing on top: per-page refcounts, a
**radix tree over token ids** (token-granular matching — partial-page
prefixes share too, and decode-generated pages can be registered for
n-gram continuation reuse), and copy-on-write so common prefixes occupy
physical pages once. Under sharing, ``free_blocks`` counts free *plus
reclaimable cached* pages — still the truthful capacity signal, because
cached pages are evictable on demand.

Page id 0 is reserved as the garbage page: it is never handed out, and the
model's masked writes (chunk padding, inactive decode lanes) land there
(see ``models/transformer.init_paged_cache``). Physical arrays therefore
have ``n_pages + 1`` rows for ``n_pages`` usable pages.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.kvcache import BlockPool

GARBAGE_PAGE = 0

# radix fanout past which a node gets a first-token child index
# (_RadixNode.child_idx): below this, the linear scan is cheaper than
# dict upkeep; above it — the root of a many-session cache — the scan
# is the dominant cost of every match/register walk
_INDEX_FANOUT = 16


class PagedBlockAllocator(BlockPool):
    """BlockPool accounting + physical page ids + per-request block tables."""

    def __init__(self, n_pages: int, page_size: int = 16):
        super().__init__(n_pages * page_size, page_size)
        assert self.total_blocks == n_pages
        self.n_pages = n_pages
        # LIFO free-list of physical ids; id 0 is the reserved garbage page
        self._free_ids: List[int] = list(range(n_pages, 0, -1))
        self.tables: Dict[int, List[int]] = {}
        # fault injection (ft/faults.py alloc_fail bursts): while set, every
        # allocation that would take NEW pages fails — a device memory
        # fault, not capacity pressure. Growth that is already backed still
        # succeeds, so the failure mode is honest about what broke.
        self.force_alloc_fail = False

    # ---- allocation -----------------------------------------------------
    def allocate(self, req_id: int, tokens: int) -> bool:
        """Grow req's block table to cover ``tokens`` total. False if OOM.

        Atomic on failure: the availability check precedes every mutation,
        so a False return leaves ``_free_ids``, ``tables`` and the
        BlockPool books untouched (asserted — partial-OOM must not leak)."""
        held = len(self.tables.get(req_id, []))
        need = self.blocks_for(tokens, self.block_size) - held
        if need <= 0:
            return True
        if self.force_alloc_fail or need > len(self._free_ids):
            return False
        pre_free = len(self._free_ids)
        pages = [self._free_ids.pop() for _ in range(need)]
        assert len(pages) == need and len(self._free_ids) == pre_free - need
        self.tables.setdefault(req_id, []).extend(pages)
        # mirror into the BlockPool books (kv_usage reads these)
        self.free_blocks -= need
        self._held[req_id] = self._held.get(req_id, 0) + need
        self.stat_blocks_allocated += need
        return True

    def free(self, req_id: int) -> None:
        for p in reversed(self.tables.pop(req_id, [])):
            self._free_ids.append(p)
        super().free(req_id)

    # ---- block-table views ---------------------------------------------
    def table_of(self, req_id: int) -> List[int]:
        return self.tables.get(req_id, [])

    def block_table_array(self, req_ids: Sequence[Optional[int]],
                          max_blocks: int) -> np.ndarray:
        """(len(req_ids), max_blocks) int32, garbage-page padded. ``None``
        entries produce all-garbage rows (inactive decode lanes)."""
        out = np.full((len(req_ids), max_blocks), GARBAGE_PAGE, np.int32)
        for i, rid in enumerate(req_ids):
            if rid is None:
                continue
            t = self.tables.get(rid, [])
            out[i, :len(t)] = t[:max_blocks]
        return out

    def check_invariants(self) -> None:
        """Accounting and physical views must agree (test hook)."""
        assert self.free_blocks == len(self._free_ids), \
            (self.free_blocks, len(self._free_ids))
        held = sorted(p for t in self.tables.values() for p in t)
        assert GARBAGE_PAGE not in held
        assert len(set(held)) == len(held), "page double-booked"
        assert len(held) + len(self._free_ids) == self.n_pages
        for rid, t in self.tables.items():
            assert self._held.get(rid, 0) == len(t)


class _RadixNode:
    """One radix-tree edge: a token span within a single page slot.

    ``tokens`` are the edge label starting at absolute ``depth``;
    ``page`` holds valid KV for every depth in ``[slot_start, end)`` where
    ``slot_start = (depth // page_size) * page_size`` — the offsets before
    ``depth`` were either written by the registering request or inherited
    through a whole-page COW copy, so a matcher can always attach the
    *deepest* node's page per slot. Spans never cross a page boundary.
    """

    __slots__ = ("tokens", "page", "depth", "parent", "children",
                 "expires_at", "child_idx")

    def __init__(self, tokens: List[int], page: int, depth: int,
                 parent: Optional["_RadixNode"],
                 expires_at: Optional[float] = None):
        self.tokens = list(tokens)
        self.page = page
        self.depth = depth
        self.parent = parent
        self.children: List["_RadixNode"] = []
        # TTL policy for finish-time decode-token registrations: None
        # means the entry never expires (the default for prompt pages)
        self.expires_at = expires_at
        # lazy first-token -> children index, built once fanout crosses
        # _INDEX_FANOUT (the root of a many-session cache has thousands
        # of children; cp > 0 requires tokens[0] to match, so bucketing
        # by first token is exact and turns the O(children) scan into a
        # dict hit)
        self.child_idx: Optional[Dict[int, List["_RadixNode"]]] = None

    @property
    def end(self) -> int:
        return self.depth + len(self.tokens)


def _common_prefix(a: Sequence, b: Sequence) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class SharedPagedAllocator(PagedBlockAllocator):
    """Prefix-sharing paged allocator: ref-counted pages + COW block tables.

    The vLLM/SGLang prefix-caching design with a **radix tree over token
    ids** as the index, kept truthful for Algorithm 1:

    * :meth:`register_prefix` indexes a request's pages under the token
      sequence they store — *token-granular*: partial pages (a prompt tail,
      decode-generated tokens at finish) are indexed too, so later arrivals
      match mid-page and n-gram continuations of finished requests hit.
      First writer wins: spans already covered keep their existing node;
    * :meth:`match_prefix` (called at admission) walks the tree for the
      longest token prefix of the new request, attaching the deepest
      matched node's page per page slot (refcount += 1), so prefill starts
      at the first unshared *token* — not the first unshared page;
    * indexed pages are immutable. :meth:`prepare_write` must be called
      before any KV write: pages that are shared (refcount > 1) or indexed
      are replaced by private copies (copy-on-write) and the (src, dst)
      pairs are returned for the engine to apply to the physical arrays;
    * a page whose refcount drops to 0 stays cached (LRU-reclaimable) while
      indexed, so requests arriving after the owner finished still hit.
      Eviction is leaf-first so interior nodes never strand reachable
      cached descendants; when only interior pages are cached, the LRU
      page's whole subtree is evicted with it (cached descendants are
      reclaimed too, live ones merely lose their index entry).

    Shared-aware accounting: ``free_blocks`` (hence ``kv_usage``) counts
    each physical page once — free and cached pages are both capacity,
    because cached pages are evicted on demand by ``allocate``/COW.
    """

    def __init__(self, n_pages: int, page_size: int = 16):
        super().__init__(n_pages, page_size)
        self.refcount: Dict[int, int] = {}        # live pages only (>= 1)
        self._root = _RadixNode([], GARBAGE_PAGE, 0, None)
        self._page_node: Dict[int, _RadixNode] = {}   # indexed pages only
        # refcount-0 indexed pages, insertion order == LRU eviction order
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._matched: Dict[int, Tuple[int, int]] = {}  # rid -> (pages, toks)
        self.stat_evictions = 0
        self.stat_expirations = 0
        # monotone index-mutation counter: bumps whenever the radix tree
        # changes shape (register/evict/expire). PrefixSummary stamps it,
        # so engines can ship cheap deltas between unchanged versions and
        # the trace table can validate delta chains (core/traces.py).
        self.summary_version = 0
        # incremental summary state: per-root-child digest memo keyed by
        # node identity, with mutated subtrees dirty-marked at the two
        # tree-shape mutation sites. prefix_summary() re-walks only the
        # dirty subtrees and folds their diff into a maintained aggregate
        # — O(changes), not O(cache), per trace under heavy churn
        # (session workloads). _summary_keys tracks which root children
        # contribute each digest key so removals re-derive the max
        # correctly even under (rare) fingerprint collisions.
        self._summary_memo: Dict[int, Tuple[Dict[int, int], int]] = {}
        self._summary_dirty: Dict[int, _RadixNode] = {}
        self._summary_keys: Dict[int, Dict[int, int]] = {}
        self._summary_agg: Dict[int, int] = {}
        self._summary_total = 0
        self._summary_changed: set = set()

    # ---- tree walking ----------------------------------------------------
    def _best_child(self, node: _RadixNode, tokens: Sequence,
                    d: int) -> Tuple[Optional[_RadixNode], int]:
        """Child of ``node`` with the longest common prefix against
        ``tokens[d:]``. Siblings may share leading tokens (divergent
        continuations register side by side instead of splitting, since a
        node owns exactly one physical page), so this scans; first
        strictly-longer match wins, which keeps the walk deterministic."""
        cands = node.children
        if len(cands) > _INDEX_FANOUT:
            if node.child_idx is None:
                idx: Dict[int, List[_RadixNode]] = {}
                for c in cands:
                    idx.setdefault(c.tokens[0], []).append(c)
                node.child_idx = idx
            cands = node.child_idx.get(tokens[d], ())
        best, best_cp = None, 0
        for c in cands:
            cp = _common_prefix(c.tokens, tokens[d:d + len(c.tokens)])
            if cp > best_cp:
                best, best_cp = c, cp
        return best, best_cp

    # ---- physical page sourcing -----------------------------------------
    def _evict(self, node: _RadixNode) -> None:
        """Drop ``node``'s subtree from the index. Cached descendant pages
        (beyond the node's own, which the caller is taking) go back to the
        free list; live descendant pages stay owned by their requests and
        simply stop being matchable — nothing cached is ever stranded
        unreachable behind an evicted interior node."""
        if node.parent is self._root:      # whole top-level digest gone
            self._summary_apply(id(node), {}, 0)
            self._summary_dirty.pop(id(node), None)
        else:
            self._summary_touch(node.parent)
        node.parent.children.remove(node)
        idx = node.parent.child_idx
        if idx is not None:
            bucket = idx[node.tokens[0]]
            bucket.remove(node)
            if not bucket:
                del idx[node.tokens[0]]
        self.summary_version += 1
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children)
            del self._page_node[n.page]
            self.stat_evictions += 1
            if n.page in self._cached:
                del self._cached[n.page]
                if n is not node:
                    self._free_ids.append(n.page)

    def _take_page(self) -> int:
        """Pop a physical page: the free list first, else evict a cached
        page — LRU among tree leaves so ancestors stay matchable; if every
        cached page is interior, the LRU one goes with its whole subtree.
        Caller updates the books."""
        if self._free_ids:
            return self._free_ids.pop()
        for p in self._cached:                    # insertion order == LRU
            if not self._page_node[p].children:
                self._evict(self._page_node[p])
                return p
        p = next(iter(self._cached))
        self._evict(self._page_node[p])
        return p

    def _unref(self, p: int) -> None:
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            del self.refcount[p]
            if p in self._page_node:      # keep content reusable (LRU cache)
                self._cached[p] = None
            else:
                self._free_ids.append(p)
            self.free_blocks += 1

    # ---- allocation ------------------------------------------------------
    def allocate(self, req_id: int, tokens: int) -> bool:
        """Grow req's table to cover ``tokens`` total; may evict cached
        pages. Atomic on failure (books untouched when returning False)."""
        held = len(self.tables.get(req_id, []))
        need = self.blocks_for(tokens, self.block_size) - held
        if need <= 0:
            return True
        if self.force_alloc_fail:         # injected device fault burst
            return False
        if need > self.free_blocks:       # free list + reclaimable cache
            return False
        pages = []
        for _ in range(need):
            p = self._take_page()
            self.refcount[p] = 1
            pages.append(p)
        self.tables.setdefault(req_id, []).extend(pages)
        self.free_blocks -= need
        self._held[req_id] = self._held.get(req_id, 0) + need
        self.stat_blocks_allocated += need
        return True

    def free(self, req_id: int) -> None:
        """Detach the request: decrement refcounts; pages still referenced
        by peers stay live, indexed pages go to the reclaimable cache."""
        for p in self.tables.pop(req_id, []):
            self._unref(p)
        self._held.pop(req_id, None)
        self._matched.pop(req_id, None)

    def release_match(self, req_id: int) -> None:
        """Roll back a speculative admission match whose allocate failed:
        detach the pages AND uncount the hit telemetry. A request stuck at
        the head of the queue under KV pressure re-matches every step; a
        match that never skipped any prefill must not inflate
        ``stat_hit_tokens`` (the cluster's cache-hit signals)."""
        pages, toks = self._matched.get(req_id, (0, 0))
        self.stat_hit_pages -= pages
        self.stat_hit_tokens -= toks
        self.stat_hit_tokens_page -= (toks // self.block_size) \
            * self.block_size
        self.free(req_id)

    # ---- prefix sharing --------------------------------------------------
    def _attach_slot(self, node: _RadixNode) -> Optional[int]:
        """Take one admission-match reference on ``node``'s page, reviving
        it from the reclaimable cache if needed, and return the physical
        page id. Subclass hook: the tiered allocator overrides this to
        rematerialize pages archived to the host tier, returning ``None``
        when no device page can back the slot (the match truncates)."""
        p = node.page
        if p in self._cached:                 # revive a reclaimable page
            del self._cached[p]
            self.refcount[p] = 1
            self.free_blocks -= 1
        else:
            self.refcount[p] += 1
        return p

    def match_prefix(self, req_id: int, tokens: Sequence) -> int:
        """Attach the longest cached *token* prefix of ``tokens`` to
        ``req_id``'s block table: walk the radix tree, keep the deepest
        matched node's page per page slot, refcount each attached page.
        Returns the matched token count — any value, not just page
        multiples. The caller decides how much prefill to skip — at least
        the last prompt token must be recomputed so its logits can seed
        sampling. A request with a non-empty table (resume mid-life) is a
        defined no-op returning 0: its pages already cover its state."""
        if self.tables.get(req_id):
            return 0
        node, d = self._root, 0
        slot_node: Dict[int, _RadixNode] = {}
        while d < len(tokens):
            child, cp = self._best_child(node, tokens, d)
            if child is None or cp == 0:
                break
            slot_node[child.depth // self.block_size] = child
            if child.page in self._cached:        # touch LRU recency
                self._cached.move_to_end(child.page)
            d = child.depth + cp
            if cp < len(child.tokens):
                break                             # partial-page match: stop
            node = child
        if d == 0:
            return 0
        # attach slot by slot, in order, so a subclass that must source a
        # physical page per slot (the tiered allocator rematerializing an
        # archived page) can truncate the match to a page-aligned prefix
        # when the pool cannot back a deeper slot
        table: List[int] = []
        for s in range((d - 1) // self.block_size + 1):
            p = self._attach_slot(slot_node[s])
            if p is None:
                d = s * self.block_size
                break
            table.append(p)
        if d == 0:
            return 0
        self.tables[req_id] = table
        self._held[req_id] = len(table)
        self._matched[req_id] = (len(table), d)   # release_match rollback
        self.stat_hit_pages += len(table)
        self.stat_hit_tokens += d
        self.stat_hit_tokens_page += (d // self.block_size) * self.block_size
        return d

    def register_prefix(self, req_id: int, tokens: Sequence,
                        expires_at: Optional[float] = None) -> None:
        """Index ``req_id``'s pages storing ``tokens`` (prompt prefix, or
        prompt + generated tokens at finish) so later arrivals share them —
        token-granular: the trailing partial page is indexed too. First
        writer wins: spans already covered by the tree keep their existing
        node (re-registering a grown prefix just extends the frontier).
        Only pages not yet indexed gain nodes; indexed pages are immutable
        (COW guarantees a request's own written pages are private).
        ``expires_at`` stamps a TTL on the *newly created* nodes (decode-
        token caching policy): :meth:`expire_registrations` sweeps them;
        nodes an earlier registration already owns keep their lifetime."""
        table = self.tables.get(req_id, [])
        ps = self.block_size
        limit = min(len(tokens), len(table) * ps)
        node, d = self._root, 0
        while d < limit:
            child, cp = self._best_child(node, tokens, d)
            if child is not None and cp == len(child.tokens):
                node = child                      # covered: descend
                d += cp
                continue
            end = min((d // ps + 1) * ps, limit)
            span = list(tokens[d:end])
            if child is not None and cp == len(span):
                break        # an existing node already covers this tail
            page = table[d // ps]
            if page in self._page_node:
                break        # already indexed under another span
            new = _RadixNode(span, page, d, node, expires_at=expires_at)
            node.children.append(new)
            if node.child_idx is not None:
                node.child_idx.setdefault(span[0], []).append(new)
            self._page_node[page] = new
            self._summary_touch(new)
            self.summary_version += 1
            node = new
            d = end

    def expire_registrations(self, now: float) -> int:
        """Evict radix entries whose TTL has lapsed (decode-token caching
        policy). Deepest-first, so the common case — an expiring finish-
        time tail under a permanent prompt prefix — drops exactly the
        tail. An expired *interior* node takes its subtree with it (the
        established eviction semantic: cached descendants are reclaimed,
        live ones only lose their index entry). Returns entries evicted."""
        expired: List[_RadixNode] = []
        stack = list(self._root.children)
        while stack:
            n = stack.pop()
            stack.extend(n.children)
            if n.expires_at is not None and n.expires_at <= now:
                expired.append(n)
        n_evicted = 0
        for n in sorted(expired, key=lambda n: -n.depth):
            if n.page not in self._page_node:
                continue      # already gone via an expired ancestor
            cached_own = n.page in self._cached
            self._evict(n)
            if cached_own:    # _evict leaves the root page to its caller
                self._free_ids.append(n.page)
            n_evicted += 1
            self.stat_expirations += 1
        return n_evicted

    def prepare_write(self, req_id: int, start_tok: int,
                      end_tok: int) -> Optional[List[Tuple[int, int]]]:
        """Copy-on-write ahead of a KV write into tokens [start_tok,
        end_tok): every touched page that is shared (refcount > 1) or
        indexed (immutable cached content) is swapped for a private copy.
        Returns the (src, dst) page pairs the engine must apply to the
        physical arrays, or None when the pool cannot back the copies
        (caller preempts or stalls). Atomic on failure."""
        if end_tok <= start_tok:
            return []
        table = self.tables.get(req_id, [])
        lo = start_tok // self.block_size
        hi = min(-(-end_tok // self.block_size), len(table))
        idxs = [i for i in range(lo, hi)
                if self.refcount[table[i]] > 1
                or table[i] in self._page_node]
        if not idxs:
            return []
        if len(idxs) > self.free_blocks:
            return None
        copies: List[Tuple[int, int]] = []
        for i in idxs:
            src = table[i]
            dst = self._take_page()
            self.refcount[dst] = 1
            self.free_blocks -= 1
            self._unref(src)      # indexed sole-owner src -> cache (net 0)
            table[i] = dst
            copies.append((src, dst))
        self.stat_blocks_allocated += len(copies)
        self.stat_cow_copies += len(copies)
        return copies

    # ---- introspection ---------------------------------------------------
    @property
    def n_cached(self) -> int:
        return len(self._cached)

    @property
    def pages_in_use(self) -> int:
        """Distinct physical pages currently backing live block tables."""
        return self.n_pages - len(self._free_ids) - len(self._cached)

    def _summary_touch(self, node: _RadixNode) -> None:
        """Dirty-mark the top-level subtree containing ``node``: its memoized
        digest is stale and will be re-walked on the next summary build."""
        while node.parent is not self._root:
            node = node.parent
        self._summary_dirty[id(node)] = node

    def _summary_apply(self, rid: int, sub: Dict[int, int],
                       total: int) -> None:
        """Replace root-child ``rid``'s contribution to the aggregate
        digest with ``(sub, total)`` (empty = remove it entirely)."""
        old_sub, old_t = self._summary_memo.pop(rid, ({}, 0))
        self._summary_total += total - old_t
        changed = self._summary_changed
        for k in old_sub:
            owners = self._summary_keys.get(k)
            if owners is None:
                continue
            owners.pop(rid, None)
            if owners:
                m = max(owners.values())
                if self._summary_agg.get(k) != m:
                    self._summary_agg[k] = m
                    changed.add(k)
            else:
                del self._summary_keys[k]
                self._summary_agg.pop(k, None)
                changed.add(k)
        for k, v in sub.items():
            self._summary_keys.setdefault(k, {})[rid] = v
            if v > self._summary_agg.get(k, -1):
                self._summary_agg[k] = v
                changed.add(k)
        if sub or total:
            self._summary_memo[rid] = (sub, total)

    def consume_summary_changes(self) -> set:
        """Drain the set of digest keys whose aggregate entry changed
        since the last drain. Single-consumer by design: the engine's
        :class:`~repro.serving.engine_util.PrefixSummaryShipper` uses it
        to build deltas in O(changes) instead of re-diffing the full
        digest every trace. Call after :meth:`prefix_summary` (which
        flushes pending dirty subtrees into the aggregate)."""
        changed, self._summary_changed = self._summary_changed, set()
        return changed

    def _summary_dfs(self, node: _RadixNode, acc: Optional[tuple],
                     entries: Dict[int, int]) -> Tuple[int, int]:
        """Accumulate :meth:`prefix_summary` entries: ``acc`` carries the
        first-page tokens gathered so far (None once this path is keyed);
        a path is keyed at the node where it reaches one full page — or at
        its leaf, for shallower trees — and maps to the deepest token
        depth reachable below. Returns (deepest depth, indexed tokens)."""
        deepest, total = node.end, len(node.tokens)
        key_here = None
        if acc is not None:
            acc = (acc + tuple(node.tokens))[:self.block_size]
            if len(acc) >= self.block_size or not node.children:
                key_here, acc = acc, None
        for c in node.children:
            d, t = self._summary_dfs(c, acc, entries)
            deepest = max(deepest, d)
            total += t
        if key_here is not None:
            k = hash(key_here)
            entries[k] = max(entries.get(k, 0), deepest)
        return deepest, total

    def prefix_summary(self):
        """Compact digest of the radix tree for the DP scheduler's
        prefix-affinity signal: fingerprints of each distinct root-level
        first page (or shorter leaf path) mapped to the deepest matchable
        token depth beneath it, plus the total indexed token count. A few
        ints per distinct system prompt — cheap enough to ride every
        :class:`~repro.core.traces.EngineTrace`."""
        from repro_torch.core.traces import PrefixSummary
        if self._summary_dirty:
            dirty, self._summary_dirty = self._summary_dirty, {}
            for rid, node in dirty.items():
                if node.parent is not self._root:
                    continue               # evicted (already subtracted)
                sub: Dict[int, int] = {}
                _, t = self._summary_dfs(node, (), sub)
                self._summary_apply(rid, sub, t)
        return PrefixSummary(block_size=self.block_size,
                             entries=dict(self._summary_agg),
                             indexed_tokens=self._summary_total,
                             version=self.summary_version)

    def check_invariants(self) -> None:
        """Sharing-aware books must balance (test hook): every physical
        page is in exactly one of {free list, reclaimable cache, live
        refcounted set}; refcounts equal table multiplicity; kv_usage
        counts physical pages once; the radix tree is a page <-> node
        bijection of contiguous, slot-local spans with every indexed page
        (in particular every cached page — eviction must never strand one)
        reachable from the root."""
        assert self.free_blocks == len(self._free_ids) + len(self._cached), \
            (self.free_blocks, len(self._free_ids), len(self._cached))
        counts: Dict[int, int] = {}
        for t in self.tables.values():
            for p in t:
                counts[p] = counts.get(p, 0) + 1
        assert counts == self.refcount, "refcount != table multiplicity"
        assert all(c >= 1 for c in self.refcount.values())
        fs, cs, hs = set(self._free_ids), set(self._cached), set(counts)
        assert GARBAGE_PAGE not in fs | cs | hs, "garbage page handed out"
        assert not (fs & cs) and not (fs & hs) and not (cs & hs), \
            "page in two ownership states"
        assert len(self._free_ids) == len(fs), "free-list duplicate"
        assert len(fs) + len(cs) + len(hs) == self.n_pages
        for rid, t in self.tables.items():
            assert self._held.get(rid, 0) == len(t)
        assert set(self._matched) <= set(self.tables), "stale match memo"
        # radix tree structure: reachable nodes <-> indexed pages
        seen: Dict[int, _RadixNode] = {}
        stack = [self._root]
        while stack:
            n = stack.pop()
            if n.child_idx is not None:
                # the first-token index must be exactly the children list,
                # bucketed — a missed maintenance hook would silently hide
                # cached prefixes from every subsequent match
                rebuilt: Dict[int, List[_RadixNode]] = {}
                for c in n.children:
                    rebuilt.setdefault(c.tokens[0], []).append(c)
                assert n.child_idx == rebuilt, "stale first-token index"
            for c in n.children:
                assert c.parent is n, "broken parent link"
                assert c.depth == n.end, "non-contiguous child depth"
                assert len(c.tokens) >= 1, "empty edge"
                assert c.depth % self.block_size + len(c.tokens) \
                    <= self.block_size, "edge crosses a page boundary"
                assert c.page not in seen, "page owned by two nodes"
                seen[c.page] = c
                stack.append(c)
        assert seen == self._page_node, \
            "unreachable index entry (stranded page)"
        assert cs <= set(seen), "cached page not indexed"
        assert not (set(seen) & fs), "indexed page on the free list"
        assert 0.0 <= self.usage <= 1.0
        # the incremental (memoized) prefix digest must equal a fresh
        # full-tree walk — a missed dirty-mark would silently feed the
        # scheduler stale affinity depths
        fresh: Dict[int, int] = {}
        fresh_total = 0
        for c in self._root.children:
            _, t = self._summary_dfs(c, (), fresh)
            fresh_total += t
        summ = self.prefix_summary()
        assert summ.entries == fresh and summ.indexed_tokens == fresh_total, \
            "memoized prefix summary diverged from the tree"
