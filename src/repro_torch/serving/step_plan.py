"""Declarative per-step planning for the serving engines (plan/execute).

``StepPlanner`` is the single owner of the per-step *control* decisions a
continuous-batching engine must make — admission (queue ordering + first
KV reservation + prefix-cache attach), KV growth with copy-on-write,
preemption under pressure, and token-budget packing of prefill chunks.
It emits a declarative :class:`StepPlan` — decode lanes plus prefill
lanes with per-lane chunk spans, already packed into fused dispatch
groups — which a *data plane* then executes: the real paged engine runs
one batched ``prefill_chunk_paged`` call per group (B > 1 lanes fused
into one jit dispatch), the simulator prices the same plan through its
cost model.

Both planes instantiate the SAME planner class over the same allocator
types, so packing/budget semantics cannot silently diverge between the
simulated and real data planes — Algorithm 1's pressure signals
(remaining/waiting prefill, kv_usage, stalls, dispatch counts) stay
comparable by construction. Plane-specific conventions enter only
through :class:`PlannerConfig` (the simulator's legacy ``context_len+1``
decode reservation, its never-preempt non-sharing prefill path) and the
host callbacks (queue policy, preemption victim, physical COW applies).

The plan obeys invariants that :func:`check_plan_invariants` asserts
(the property-test hook):

* budget — decode lanes + planned prefill chunks never exceed the step
  token budget (prefill packs into ``token_budget - n_decode``);
* liveness — no planned lane references a preempted, stalled, waiting or
  finished request; every planned request appears exactly once;
* growth atomicity — every planned lane's block table already covers the
  tokens the data plane will write (growth happened at plan time, with
  preemption/stall fallback, never mid-execution);
* grouping — prefill groups respect ``lanes_per_dispatch`` and preserve
  packing order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.serving.engine_util import (grow_with_cow, match_prefix_on_admit,
                                       release_prefix_match,
                                       select_preemption_victim)
from repro_torch.serving.kv_tier import SwapRecord
from repro_torch.serving.request import Request, RequestState


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Packing/budget semantics of one engine's step planner."""

    token_budget: int                 # per-step chunked-prefill token budget
    max_running: int                  # admission cap on concurrent requests
    chunk_cap: int = 0                # max prefill chunk per lane (0 = budget)
    lanes_per_dispatch: int = 1       # prefill lanes fused per data-plane call
    sharing: bool = False             # prefix cache + COW growth
    # simulator legacy: reserve context_len + 1 tokens per decode step
    # (one ahead of the write); the paged plane reserves exactly the write
    decode_reserve_extra: int = 0
    # may prefill growth preempt peers? The paged plane always may (without
    # it admitted prefills deadlock waiting for each other's next chunk);
    # the simulator's non-sharing path historically skips instead
    prefill_preempt: bool = True
    # preemption flavor over a tiered pool (kv_tier.py): "recompute"
    # (classic — victims lose their KV and re-prefill), "swap" (victims'
    # pages always move to the host tier, restored at re-admission), or
    # "auto" (the measured SwapCostModel picks per victim). Ignored when
    # the pool has no tier behind it.
    swap_policy: str = "recompute"
    # mixed fused steps: decode lanes become 1-token prefill-like lanes
    # and join the prefill lanes in ``StepPlan.mixed_groups`` — one model
    # dispatch per group under the same token budget. The split
    # decode/prefill_groups lists stay populated (they carry the step's
    # semantics either way); the data plane executes mixed_groups when
    # non-empty.
    mixed_steps: bool = False
    # cost-aware grouping inputs (mixed_steps): the data plane pads a
    # group to (lane_bucket(B), chunk_bucket(max chunk)), so the planner
    # prices candidate groups in padded tokens plus a fixed per-dispatch
    # overhead and partitions size-sorted lanes to minimize the total.
    # Empty bucket tuples price at the exact (B, S) — the sim default.
    lane_buckets: Tuple[int, ...] = ()
    chunk_buckets: Tuple[int, ...] = ()
    # modeled fixed cost of one model dispatch, in padded-token
    # equivalents (kernel launch + MoE all-to-all): raising it makes the
    # grouper fuse more aggressively, 0 never fuses lanes whose bucket
    # padding outweighs the saved dispatch
    dispatch_overhead_tokens: int = 16


@dataclasses.dataclass(frozen=True)
class PrefillLane:
    """One request's chunk span within a fused prefill dispatch.

    ``decode=True`` marks a 1-token decode lane riding a mixed fused
    dispatch (``StepPlan.mixed_groups``): ``start`` is the request's
    written KV length, the token comes from its output stream, and the
    lane's chunk-end logits are the next-token distribution.
    """

    req: Request
    start: int          # == req.prefill_done at plan time (decode: written)
    chunk: int          # tokens to prefill this step (>= 1; decode: == 1)
    decode: bool = False


@dataclasses.dataclass
class StepPlan:
    """Declarative step: what the data plane executes, nothing it decides."""

    decode: List[Request]
    prefill_groups: List[List[PrefillLane]]
    n_stalled: int = 0
    n_admitted: int = 0
    prefix_hit_tokens: int = 0        # admission-time cache hits (sharing)
    # tier transfers decided (and executed) while planning this step —
    # the data plane prices/report them, it does not re-run them
    swap_out: List[SwapRecord] = dataclasses.field(default_factory=list)
    swap_in: List[SwapRecord] = dataclasses.field(default_factory=list)
    # head-of-line swap-ins the pool could not back this step (tiered
    # pools only): admission stalled on a swapped request — distinct from
    # an ordinary full-pool stall, so Algorithm 1 can see tier pressure
    swap_in_blocked: int = 0
    # mixed fused dispatch groups (PlannerConfig.mixed_steps): decode
    # lanes as 1-token PrefillLane(decode=True) plus the prefill lanes,
    # partitioned by the cost-aware grouper. Non-empty ⇒ the data plane
    # runs ONE model call per group instead of decode + prefill_groups;
    # ``decode``/``prefill_groups`` still carry the step's semantics
    # (effects, pricing, invariants) and must cover the same requests.
    mixed_groups: List[List[PrefillLane]] = dataclasses.field(
        default_factory=list)

    @property
    def prefill_lanes(self) -> List[PrefillLane]:
        return [l for g in self.prefill_groups for l in g]

    @property
    def prefill_tokens(self) -> int:
        return sum(l.chunk for l in self.prefill_lanes)

    @property
    def has_work(self) -> bool:
        return bool(self.decode or self.prefill_groups or self.n_stalled)


def bucket_up(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n (identity when no buckets; the largest bucket
    when n exceeds them all — callers bound n separately)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] if buckets else n


def mixed_chunk_bucket(chunk: int, chunk_buckets: Tuple[int, ...]) -> int:
    """Padded S for a mixed dispatch: the prefill chunk buckets plus an
    S=1 bucket, so an all-decode group lowers to the decode shape instead
    of paying the smallest prefill bucket. The single definition — the
    planner's grouping cost and the runner's padding must agree."""
    return bucket_up(chunk, (1,) + tuple(chunk_buckets))


def written_kv_len(r: Request) -> int:
    """Tokens currently stored in the request's KV: the prompt prefix plus
    one page-written token per decode step already taken — the newest
    sampled token's KV is never written yet. The single definition of the
    written-KV convention: the planner's growth windows and the engines'
    decode lengths / finish-time registration caps all read this."""
    return r.prefill_done + max(r.generated - 1, 0)


class StepPlanner:
    """Admission + growth + packing for one engine (see module docstring).

    The host engine provides its mutable queues (``waiting``/``running``
    attributes) and three callbacks: ``order_waiting(waiting, now)`` (the
    intra-engine queue policy), ``preempt_one(protect)`` (evict a victim,
    reclaim its KV, requeue it — returns False when nothing can yield)
    and optionally ``apply_copies(pairs)`` (apply COW page copies to the
    physical arrays; None for the bookkeeping-only simulator).
    """

    def __init__(self, cfg: PlannerConfig, pool, host, *,
                 order_waiting: Callable,
                 preempt_one: Callable[[Optional[Request]], bool],
                 apply_copies: Optional[Callable] = None,
                 swap_cost=None,
                 select_victim: Optional[Callable] = None):
        self.cfg = cfg
        self.pool = pool
        self.host = host
        self._order_waiting = order_waiting
        self._preempt_one = preempt_one
        self._apply_copies = apply_copies
        # swap-vs-recompute machinery (tiered pools only): the cost model
        # prices both sides under "auto"; the victim selector defaults to
        # the shared recompute-mode policy so swap and recompute evict the
        # same request — only its KV's fate differs
        self._swap_cost = swap_cost
        self._select_victim = select_victim or \
            (lambda protect: select_preemption_victim(self.host.running,
                                                      protect))
        self._swap_out_recs: List[SwapRecord] = []
        self._swap_in_recs: List[SwapRecord] = []
        self._swap_in_blocked = 0
        self._decode_rr = 0       # round-robin offset when the decode cap
                                  # binds, so deferred lanes never starve

    # ---- preemption: swap-vs-recompute -----------------------------------
    def _try_swap_out(self, protect: Optional[Request]) -> bool:
        """Preempt by swapping the victim's pages to the host tier,
        keeping its prefill/decode progress. False falls back to classic
        recompute preemption (policy says so, no tier, tier full, or the
        victim has nothing worth saving)."""
        pool = self.pool
        if self.cfg.swap_policy == "recompute" \
                or not hasattr(pool, "swap_out_request"):
            return False
        victim = self._select_victim(protect)
        if victim is None:
            return False
        tokens = written_kv_len(victim)
        if tokens <= 0:
            return False              # nothing written: recompute is free
        if self.cfg.swap_policy == "auto" and self._swap_cost is not None:
            nbytes = len(pool.table_of(victim.req_id)) \
                * pool.tier.page_nbytes
            if not self._swap_cost.prefer_swap(
                    victim.prefill_done, max(victim.generated - 1, 0),
                    nbytes):
                return False
        rec = pool.swap_out_request(victim.req_id, tokens)
        if rec is None:
            return False
        host = self.host
        host.running.remove(victim)
        victim.n_preemptions += 1
        victim.state = RequestState.PREEMPTED
        host.waiting.append(victim)
        self._swap_out_recs.append(rec)
        return True

    def _preempt(self, protect: Optional[Request]) -> bool:
        if self._try_swap_out(protect):
            return True
        # recompute preemption wipes the victim's progress; remember how
        # much KV it lost so re-admission can demand that much projected
        # headroom back (the anti-thrash gate in _admit)
        before = list(self.host.running)
        written = {r.req_id: written_kv_len(r) for r in before}
        if not self._preempt_one(protect):
            return False
        still = {r.req_id for r in self.host.running}
        for r in before:
            if r.req_id not in still:
                r.preempt_written = written[r.req_id]
        return True

    # ---- admission -------------------------------------------------------
    def _headroom_for(self, r: Request, first: int) -> bool:
        """Anti-thrash re-admission gate: a recompute-preempted request
        may only come back when the pool's FREE blocks cover the KV it
        lost at eviction plus its next chunk — i.e. the projected
        footprint is allocatable without evicting a peer. Re-admitting
        into the hole its own eviction opened just evicts the evictor
        back (the recompute-mode ping-pong the planner property test
        documents); demanding the lost footprint as headroom means every
        re-admission round coincides with real peer progress, which
        bounds thrash. The projection is capped at the request's full
        trajectory (a finished-size footprint can always be demanded)."""
        pool = self.pool
        projected = min(r.preempt_written + r.prefill_done + first,
                        r.prompt_len + r.max_new_tokens)
        need = pool.blocks_for(projected, pool.block_size)
        return need <= pool.free_blocks

    def _admit(self, now: float) -> Tuple[int, int]:
        host = self.host
        host.waiting = self._order_waiting(host.waiting, now)
        admitted: List[Request] = []
        hit_tokens = 0
        tiered = hasattr(self.pool, "swap_in_request")
        for r in host.waiting:
            if len(host.running) + len(admitted) >= self.cfg.max_running:
                break
            if tiered and self.pool.holds_swapped(r.req_id):
                # swapped-out victim: restore its pages from the tier in
                # place of match/allocate — its KV already exists, so
                # re-admission costs a transfer, not a recompute
                rec = self.pool.swap_in_request(r.req_id)
                if rec is None:
                    # pool cannot back it yet: no bypass. Counted, not
                    # silent — a blocked head-of-line swap-in looks like
                    # an ordinary full-pool stall otherwise
                    self._swap_in_blocked += 1
                    break
                self._swap_in_recs.append(rec)
                r.state = RequestState.RUNNING
                admitted.append(r)
                continue
            if r.n_preemptions > 0 and not self._headroom_for(
                    r, min(r.remaining_prefill, self.cfg.token_budget)):
                break   # anti-thrash gate (no bypass, like a failed alloc)
            matched = match_prefix_on_admit(self.pool, r) \
                if self.cfg.sharing else 0
            first = min(r.remaining_prefill, self.cfg.token_budget)
            if self.pool.allocate(r.req_id, r.prefill_done + first):
                hit_tokens += r.prefill_done if matched else 0
                r.state = RequestState.RUNNING
                admitted.append(r)
            else:
                if matched:
                    release_prefix_match(self.pool, r)
                break   # FIFO-in-priority-order admission (no bypass)
        for r in admitted:
            host.waiting.remove(r)
            host.running.append(r)
        return len(admitted), hit_tokens

    # ---- growth ----------------------------------------------------------
    def _grow(self, r: Request, need_tokens: int, write_lo: int,
              write_hi: int) -> bool:
        return grow_with_cow(
            self.pool, r, need_tokens, write_lo, write_hi,
            sharing=self.cfg.sharing,
            preempt_one=lambda req: self._preempt(req),
            apply_copies=self._apply_copies)

    # ---- the step plan ---------------------------------------------------
    def plan(self, now: float) -> StepPlan:
        self._swap_out_recs, self._swap_in_recs = [], []
        self._swap_in_blocked = 0
        n_admitted, hit_tokens = self._admit(now)
        running = self.host.running

        decode = [r for r in running if r.remaining_prefill == 0]
        prefill = [r for r in running if r.remaining_prefill > 0]

        # decode lanes spend the same per-step token budget prefill does
        # (one token each): cap them BEFORE growth so a deferred lane gets
        # no side effects this step — it stays RUNNING, holds its pages,
        # and decodes on a later step (round-robin, so the tail cannot
        # starve under permanent over-subscription). Without the cap,
        # len(decode) could exceed token_budget and silently over-pack
        # the step. Stall-accounted: a deferred lane is budget pressure.
        stalled = 0
        if len(decode) > self.cfg.token_budget:
            k = self._decode_rr % len(decode)
            decode = decode[k:] + decode[:k]
            stalled = len(decode) - self.cfg.token_budget
            decode = decode[:self.cfg.token_budget]
            self._decode_rr += self.cfg.token_budget

        # KV growth for decoders: preempt under pressure; if even
        # preemption cannot free a page, STALL the lane this step (no
        # token, no write) instead of decoding without backing pages.
        for r in list(decode):
            if r.state is RequestState.PREEMPTED:   # evicted by earlier lane
                decode.remove(r)
                continue
            kv = written_kv_len(r)
            if not self._grow(r, kv + 1 + self.cfg.decode_reserve_extra,
                              kv, kv + 1):
                decode.remove(r)
                stalled += 1

        # chunked prefill under the step token budget (decode lanes first).
        # Prefill growth may also preempt: without it, admitted prefills
        # can fill the pool and deadlock waiting for each other's chunks.
        budget = max(self.cfg.token_budget - len(decode), 0)
        lanes: List[PrefillLane] = []
        for r in prefill:
            if budget <= 0:
                break
            if r.state is RequestState.PREEMPTED:
                continue
            chunk = min(r.remaining_prefill, budget)
            if self.cfg.chunk_cap:
                chunk = min(chunk, self.cfg.chunk_cap)
            if self.cfg.sharing or self.cfg.prefill_preempt:
                ok = self._grow(r, r.prefill_done + chunk, r.prefill_done,
                                r.prefill_done + chunk)
            else:   # simulator legacy non-sharing path: skip, never preempt
                ok = self.pool.allocate(r.req_id, r.prefill_done + chunk)
            if not ok:
                continue
            lanes.append(PrefillLane(r, r.prefill_done, chunk))
            budget -= chunk

        # growth for a later lane may have evicted one planned earlier —
        # preempted requests must receive no data-plane effects this step
        decode = [r for r in decode if r.state is not RequestState.PREEMPTED]
        lanes = [l for l in lanes
                 if l.req.state is not RequestState.PREEMPTED]

        g = max(self.cfg.lanes_per_dispatch, 1)
        groups = [lanes[i:i + g] for i in range(0, len(lanes), g)]
        mixed = self._mixed_groups(decode, lanes) \
            if self.cfg.mixed_steps else []
        return StepPlan(decode=decode, prefill_groups=groups,
                        n_stalled=stalled, n_admitted=n_admitted,
                        prefix_hit_tokens=hit_tokens,
                        swap_out=self._swap_out_recs,
                        swap_in=self._swap_in_recs,
                        swap_in_blocked=self._swap_in_blocked,
                        mixed_groups=mixed)

    # ---- cost-aware mixed grouping ---------------------------------------
    def _mixed_groups(self, decode: List[Request],
                      lanes: List[PrefillLane]) -> List[List[PrefillLane]]:
        """Partition this step's lanes (decode as 1-token lanes plus the
        prefill lanes) into fused dispatch groups minimizing modeled
        padded cost. The data plane pads a group to
        ``(lane_bucket(B), mixed_chunk_bucket(max chunk))``, so a group's
        cost is ``dispatch_overhead_tokens + B_pad * S_pad``; lanes are
        sorted by chunk size (stable) so similar-S lanes sit adjacent and
        the optimal bucketed partition is contiguous — found exactly by a
        small DP over group sizes up to ``lanes_per_dispatch``."""
        all_lanes = [PrefillLane(r, written_kv_len(r), 1, decode=True)
                     for r in decode] + list(lanes)
        if not all_lanes:
            return []
        cfg = self.cfg
        g = max(cfg.lanes_per_dispatch, 1)
        all_lanes.sort(key=lambda l: l.chunk)   # stable: decode first
        n = len(all_lanes)
        best = [0.0] + [float("inf")] * n       # best[i]: first i lanes
        cut = [0] * (n + 1)
        for i in range(1, n + 1):
            s_pad = mixed_chunk_bucket(all_lanes[i - 1].chunk,
                                       cfg.chunk_buckets)
            for j in range(max(0, i - g), i):
                b_pad = bucket_up(i - j, cfg.lane_buckets)
                c = best[j] + cfg.dispatch_overhead_tokens + b_pad * s_pad
                if c < best[i]:
                    best[i], cut[i] = c, j
        groups: List[List[PrefillLane]] = []
        i = n
        while i > 0:
            groups.append(all_lanes[cut[i]:i])
            i = cut[i]
        groups.reverse()
        return groups


def check_plan_invariants(plan: StepPlan, cfg: PlannerConfig, pool,
                          running: List[Request]) -> None:
    """Assert the StepPlan contract (property-test hook; see module doc)."""
    seen = set()
    for r in plan.decode:
        assert r.state is RequestState.RUNNING and r in running, \
            f"decode lane on non-running request {r.req_id}"
        assert r.remaining_prefill == 0
        assert r.req_id not in seen, f"request {r.req_id} planned twice"
        seen.add(r.req_id)
        held = pool.held_tokens(r.req_id)
        assert held >= written_kv_len(r) + 1, \
            f"decode write not backed for {r.req_id}: {held} tokens held"
    budget = max(cfg.token_budget - len(plan.decode), 0)
    assert plan.prefill_tokens <= budget, \
        f"budget violated: {plan.prefill_tokens} > {budget}"
    assert len(plan.decode) + plan.prefill_tokens <= cfg.token_budget, \
        (f"step over-packed: {len(plan.decode)} decode + "
         f"{plan.prefill_tokens} prefill > {cfg.token_budget}")
    for g in plan.prefill_groups:
        assert 1 <= len(g) <= max(cfg.lanes_per_dispatch, 1), \
            "dispatch group exceeds lanes_per_dispatch"
    for l in plan.prefill_lanes:
        r = l.req
        assert r.state is RequestState.RUNNING and r in running, \
            f"prefill lane on non-running request {r.req_id}"
        assert r.req_id not in seen, f"request {r.req_id} planned twice"
        seen.add(r.req_id)
        assert l.start == r.prefill_done, "stale chunk start"
        assert 1 <= l.chunk <= r.remaining_prefill
        if cfg.chunk_cap:
            assert l.chunk <= cfg.chunk_cap
        held = pool.held_tokens(r.req_id)
        assert held >= l.start + l.chunk, \
            f"prefill write not backed for {r.req_id}: {held} tokens held"
    for rec in plan.swap_out:
        assert rec.kind == "out" and rec.n_pages >= 1 and rec.tokens >= 1
        assert rec.req_id not in seen, "swapped-out request also planned"
        assert pool.held_tokens(rec.req_id) == 0, \
            "swapped-out request still holds device pages"
    for rec in plan.swap_in:
        assert rec.kind == "in" and rec.n_pages >= 1
    if plan.mixed_groups:
        # mixed groups must be a repartition of exactly the split plan:
        # every decode request once as a 1-token decode lane over its
        # written KV, every prefill lane once and unchanged
        mixed = [l for g in plan.mixed_groups for l in g]
        assert len(mixed) == len(plan.decode) + len(plan.prefill_lanes), \
            "mixed groups do not cover the split plan"
        mixed_ids = set()
        for l in mixed:
            assert l.req.req_id not in mixed_ids, \
                f"request {l.req.req_id} in two mixed lanes"
            mixed_ids.add(l.req.req_id)
            if l.decode:
                assert l.chunk == 1 and l.start == written_kv_len(l.req), \
                    "decode lane must be one token at the written KV end"
            else:
                assert l.start == l.req.prefill_done and l.chunk >= 1
        split_ids = {r.req_id for r in plan.decode} \
            | {l.req.req_id for l in plan.prefill_lanes}
        assert mixed_ids == split_ids, "mixed/split request sets differ"
        for g in plan.mixed_groups:
            assert 1 <= len(g) <= max(cfg.lanes_per_dispatch, 1), \
                "mixed group exceeds lanes_per_dispatch"
    if hasattr(pool, "check_invariants"):
        pool.check_invariants()
