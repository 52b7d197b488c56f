"""DP inference engine: continuous batching + chunked prefill + preemption.

One engine = one DP replica (a TP group on the mesh). The engine owns a
local waiting queue (ordered by the configured intra-engine policy), a paged
KV pool, and a backend (simulated cost model or real tiny JAX model). Every
completed step produces an EngineTrace — the async trace stream Algorithm 1
consumes — and MoE routing statistics for the profiler.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.queue_policy import QueueConfig, order_queue, order_queue_fcfs
from repro_torch.core.traces import EngineTrace
from repro_torch.serving.costmodel import (EngineCostModel, SwapCostConfig,
                                     SwapCostModel)
from repro_torch.serving.engine_util import (PrefixSummaryShipper,
                                       select_preemption_victim)
from repro_torch.serving.kv_tier import HostKVTier, TieredSharedAllocator
from repro_torch.serving.kvcache import BlockPool
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.routing_sim import SourceExpertTraffic
from repro_torch.serving.step_plan import PlannerConfig, StepPlanner


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    token_budget: int = 2048          # per-step chunked-prefill budget
    max_running: int = 256
    kv_tokens: int = 700_000          # KV pool capacity (tokens/engine)
    kv_block: int = 16
    queue_policy: str = "sjf_aging"   # or "fcfs" (vLLM baseline)
    theta_age_s: float = 5.0
    # StepPlanner packing knobs, mirroring PagedEngineConfig so the sim
    # and real planes make the same packing decisions on the same trace:
    # max_chunk caps one request's per-step prefill chunk (0 = budget is
    # the only cap, the historical sim behavior); max_prefill_lanes is
    # how many prefill lanes count as one fused data-plane dispatch
    # (drives the prefill_dispatches telemetry the real plane measures)
    max_chunk: int = 0
    max_prefill_lanes: int = 8
    # ref-counted prefix cache (needs requests with prompt_tokens chains);
    # uses the SAME SharedPagedAllocator as the real paged engine, so
    # Algorithm 1 sees identical shared-aware kv_usage in sim and real
    prefix_sharing: bool = False
    # preemption flavor when a HostKVTier is attached (same semantics as
    # PagedEngineConfig.swap_policy): "recompute" | "swap" | "auto"
    swap_policy: str = "recompute"
    # mixed fused steps (same semantics as PagedEngineConfig.mixed_steps):
    # decode lanes join prefill lanes in cost-aware fused dispatch groups.
    # The sim prices the step identically either way (the cost model is
    # token-count based), so finish times match the split path exactly —
    # only the dispatch telemetry changes, mirroring what the real plane
    # would launch. Empty bucket tuples price grouping at exact (B, S).
    mixed_steps: bool = False
    lane_buckets: Tuple[int, ...] = ()
    chunk_buckets: Tuple[int, ...] = ()
    dispatch_overhead_tokens: int = 16


class DPEngine:
    def __init__(self, engine_id: int, cfg: EngineConfig,
                 cost: Optional[EngineCostModel] = None,
                 traffic: Optional[SourceExpertTraffic] = None,
                 top_k: int = 8, tier: Optional[HostKVTier] = None):
        self.engine_id = engine_id
        self.cfg = cfg
        self.cost = cost or EngineCostModel()
        self.traffic = traffic
        self.top_k = top_k
        self.tier = tier
        self.swap_cost: Optional[SwapCostModel] = None
        if tier is not None:
            # same tier class as the real plane, accounting-only payloads
            # (save/load callbacks None). Byte accounting and the swap
            # cost model both come from the roofline constants, so the
            # sim prices swap-vs-recompute with the economics the paper's
            # testbed would measure.
            if tier.page_nbytes == 0:
                tier.page_nbytes = int(cfg.kv_block
                                       * self.cost.cfg.kv_bytes_per_token)
            self.swap_cost = SwapCostModel(SwapCostConfig(
                prefill_tps=self.cost.recompute_tokens_equivalent(1.0),
                decode_step_s=self.cost.decode_time(1, 0)))
            self.pool = TieredSharedAllocator(
                max(cfg.kv_tokens // cfg.kv_block, 1), cfg.kv_block,
                tier=tier, archive_prefixes=cfg.prefix_sharing)
        elif cfg.prefix_sharing:
            from repro_torch.serving.paged import SharedPagedAllocator
            self.pool = SharedPagedAllocator(
                max(cfg.kv_tokens // cfg.kv_block, 1), cfg.kv_block)
        else:
            self.pool = BlockPool(cfg.kv_tokens, cfg.kv_block)
        self._summary_shipper = PrefixSummaryShipper(self.pool) \
            if cfg.prefix_sharing else None
        self.prefix_hit_tokens = 0
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.finished: List[Request] = []
        self.qcfg = QueueConfig(theta_age_s=cfg.theta_age_s)
        # the same planner class as PagedRealEngine over the same
        # allocator types: packing/budget decisions agree across planes
        # by construction (decode_reserve_extra=1 and the non-sharing
        # never-preempt prefill path keep the sim's legacy conventions)
        self.planner = StepPlanner(
            PlannerConfig(token_budget=cfg.token_budget,
                          max_running=cfg.max_running,
                          chunk_cap=cfg.max_chunk,
                          lanes_per_dispatch=cfg.max_prefill_lanes,
                          sharing=cfg.prefix_sharing,
                          decode_reserve_extra=1,
                          prefill_preempt=(cfg.prefix_sharing
                                           or tier is not None),
                          swap_policy=cfg.swap_policy,
                          mixed_steps=cfg.mixed_steps,
                          lane_buckets=cfg.lane_buckets,
                          chunk_buckets=cfg.chunk_buckets,
                          dispatch_overhead_tokens=(
                              cfg.dispatch_overhead_tokens)),
            self.pool, self,
            order_waiting=self._order_waiting,
            preempt_one=self._preempt_one,
            swap_cost=self.swap_cost)
        self._swap_in_bytes_window = 0.0
        # backend pressure inputs, refreshed by the coordinator each window
        self.moe_imbalance: float = 1.0
        self.remote_frac: float = 0.0
        self.moe_pressure: float = 0.0
        # step telemetry
        self.total_prefill_tokens = 0
        self.total_decode_tokens = 0
        self.busy_time = 0.0
        self.n_stalled_total = 0
        self._stalled_last = 0
        self.prefill_dispatches = 0       # fused prefill/mixed model calls
        self.prefill_lanes_total = 0      # real lanes across those calls
        self.decode_dispatches = 0        # split decode calls (0 in mixed)
        self.swap_in_blocked_total = 0
        self._swap_in_blocked_last = 0

    # ---- queue ----------------------------------------------------------
    def enqueue(self, req: Request, now: float) -> None:
        req.engine_id = self.engine_id
        req.dispatch_time = now
        # a trajectory larger than the whole pool can never complete: with
        # the stall-instead-of-corrupt growth path it would stall forever,
        # so reject it up front (mirrors the real engines)
        need = self.pool.blocks_for(req.prompt_len + req.max_new_tokens,
                                    self.cfg.kv_block)
        if need > self.pool.total_blocks:
            req.state = RequestState.FINISHED
            req.error = "prompt_exceeds_kv_capacity"
            req.finish_time = now
            self.finished.append(req)
            return
        req.state = RequestState.WAITING
        self.waiting.append(req)

    def _order_waiting(self, waiting: List[Request],
                       now: float) -> List[Request]:
        if self.cfg.queue_policy == "sjf_aging":
            return order_queue(waiting, now, self.qcfg)
        return order_queue_fcfs(waiting, now)

    # ---- preemption ------------------------------------------------------
    def _preempt_one(self, protect: Optional[Request] = None) -> bool:
        """Evict the latest-arrived decoding request (vLLM recompute mode);
        the protected lane stalls instead when nothing else can yield."""
        victim = select_preemption_victim(self.running, protect)
        if victim is None:
            return False
        self.running.remove(victim)
        self.pool.free(victim.req_id)
        victim.prefill_done = 0
        victim.generated = 0
        victim.n_preemptions += 1
        victim.state = RequestState.PREEMPTED
        self.waiting.append(victim)
        return True

    # ---- one plan/execute step --------------------------------------------
    def step(self, now: float) -> Tuple[float, Optional[np.ndarray], Dict]:
        """Returns (duration_s, routed_counts (L, E) or None, step_info).

        All control decisions (admission, KV growth/COW accounting,
        preemption, token-budget packing) live in the shared
        :class:`StepPlanner`; this method only prices and applies the
        declarative plan through the cost model."""
        plan = self.planner.plan(now)
        self.prefix_hit_tokens += plan.prefix_hit_tokens
        self._stalled_last = plan.n_stalled
        self.n_stalled_total += plan.n_stalled
        self._swap_in_blocked_last = plan.swap_in_blocked
        self.swap_in_blocked_total += plan.swap_in_blocked

        decode_reqs = plan.decode
        n_prefill = plan.prefill_tokens
        n_decode = len(decode_reqs)
        ctx = sum(r.context_len for r in decode_reqs)

        # tier transfers decided this step are priced into the step time
        # (the sim's analogue of the real plane's synchronous copies)
        swap_time = 0.0
        if self.swap_cost is not None:
            swap_time = sum(self.swap_cost.transfer_time(rec.nbytes, "out")
                            for rec in plan.swap_out) \
                + sum(self.swap_cost.transfer_time(rec.nbytes, "in")
                      for rec in plan.swap_in)
            self._swap_in_bytes_window += sum(rec.nbytes
                                              for rec in plan.swap_in)
        if n_prefill == 0 and n_decode == 0:
            if swap_time > 0.0:
                self.busy_time += swap_time
                return swap_time, None, {"swap_time": swap_time}
            return 0.0, None, {"idle": True}

        dur = self.cost.step_time(n_prefill, n_decode, ctx,
                                  self.moe_imbalance, self.remote_frac) \
            + swap_time

        # ---- apply step effects
        for lane in plan.prefill_lanes:
            r = lane.req
            r.prefill_done += lane.chunk
            if self.cfg.prefix_sharing and r.prompt_tokens:
                # mirror the paged real engine: mid-life registration stops
                # at the page boundary (indexing the in-progress partial
                # page would COW on the next write); the token-granular
                # tail + full prompt registers at finish
                full = r.prefill_done - r.prefill_done % self.cfg.kv_block
                self.pool.register_prefix(r.req_id, r.prompt_tokens[:full])
            if r.remaining_prefill == 0:
                # last prefill chunk emits the first token at step end
                r.generated = 1
                r.first_token_time = now + dur
                if r.done:
                    self._finish(r, now + dur)
        for r in decode_reqs:
            r.generated += 1
            if r.generated == 1:
                r.first_token_time = now + dur
            if r.done:
                self._finish(r, now + dur)

        self.total_prefill_tokens += n_prefill
        self.total_decode_tokens += n_decode
        if plan.mixed_groups:
            # mixed mode: the real plane would launch one fused model
            # call per group (decode lanes ride along, no decode call)
            self.prefill_dispatches += len(plan.mixed_groups)
            self.prefill_lanes_total += sum(len(g)
                                            for g in plan.mixed_groups)
        else:
            self.prefill_dispatches += len(plan.prefill_groups)
            self.prefill_lanes_total += len(plan.prefill_lanes)
            if decode_reqs:
                self.decode_dispatches += 1
        self.busy_time += dur

        routed = None
        if self.traffic is not None:
            routed = self.traffic.sample_counts(
                self.engine_id, n_prefill + n_decode, self.top_k)
            self.traffic.maybe_drift()

        return dur, routed, {"prefill_tokens": n_prefill,
                             "decode_tokens": n_decode,
                             "stalled": self._stalled_last}

    def _finish(self, r: Request, t: float) -> None:
        r.state = RequestState.FINISHED
        r.finish_time = t
        if r in self.running:
            self.running.remove(r)
        if self.cfg.prefix_sharing and r.prompt_tokens:
            # token-granular finish-time registration (the partial prompt
            # tail page becomes matchable). The simulator has no sampled
            # token ids, so only the prompt registers — decode-token
            # caching is a real-plane-only gain; the allocator semantics
            # and trace signals stay identical across planes.
            self.pool.register_prefix(r.req_id, r.prompt_tokens)
        self.pool.free(r.req_id)
        self.finished.append(r)

    # ---- trace report -----------------------------------------------------
    def trace(self, now: float, *,
              full_prefix_summary: bool = False) -> EngineTrace:
        swap_in_bytes = self._swap_in_bytes_window
        self._swap_in_bytes_window = 0.0
        return EngineTrace(
            engine_id=self.engine_id,
            remaining_prefill_tokens=float(
                sum(r.remaining_prefill for r in self.running)),
            waiting_prefill_tokens=float(
                sum(r.remaining_prefill for r in self.waiting)),
            kv_usage=self.pool.usage,
            moe_pressure=self.moe_pressure,
            n_running=len(self.running),
            n_waiting=len(self.waiting),
            n_stalled=self._stalled_last,
            swap_in_blocked=float(self._swap_in_blocked_last),
            swapped_tokens=float(getattr(self.pool, "swapped_tokens", 0)),
            swap_in_bytes=swap_in_bytes,
            # same prefix-affinity digest as the real paged engine, off
            # the same allocator class — sim/real dispatch signals agree
            # (full on first emit / resync, a delta otherwise)
            prefix_summary=self._summary_shipper.emit(
                full=full_prefix_summary)
            if self.cfg.prefix_sharing else None,
            timestamp=now,
        )

    @property
    def has_work(self) -> bool:
        return bool(self.running or self.waiting)
