"""Paged real-data-plane engine: continuous batching on physical paged KV.

``PagedRealEngine`` replaces the fixed-slot ``RealModelEngine`` data plane
with the production layout: a physical page pool shared by all requests
(``serving/paged.py``), per-request block tables, chunked prefill under a
per-step token budget, batched block-table decode
(``kernels/paged_decode``), and preemption that actually reclaims pages and
re-queues the victim through ``order_queue`` for recompute. Every trace
signal (remaining/waiting prefill tokens, token-level ``kv_usage``,
stalls) is read off the live allocator and request state, so Algorithm 1
sees honest backend pressure from the real plane — the same contract the
simulator provides.

One ``PagedModelRunner`` (the paged model entry points) is shared by all
engines of a cluster: engine identity enters as the ``source_ids``
argument. The runner's device (``PagedEngineConfig.device``, ``cuda`` by
default) decides whether the CUDA kernels or their plain CPU versions run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import counting
from repro_torch.core.queue_policy import QueueConfig, order_queue
from repro_torch.core.traces import EngineTrace
from repro_torch.models import transformer as tfm
from repro_torch.serving.costmodel import SwapCostModel
from repro_torch.bridge import tree_leaves, tree_map
from repro_torch.serving.engine_util import (PrefixSummaryShipper,
                                             drain_window_stats,
                                             select_preemption_victim)
from repro_torch.serving.kv_tier import HostKVTier, TieredSharedAllocator
from repro_torch.serving.paged import (PagedBlockAllocator,
                                       SharedPagedAllocator)
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.step_plan import (PlannerConfig, PrefillLane,
                                           StepPlan, StepPlanner,
                                           mixed_chunk_bucket, written_kv_len)


def _stats_to_numpy(stats):
    return {k: v.cpu().numpy() for k, v in stats.items()}


@dataclasses.dataclass(frozen=True)
class PagedEngineConfig:
    page_size: int = 8
    n_pages: int = 96                 # usable pages (garbage page 0 extra)
    max_blocks_per_req: int = 12      # static block-table width NB
    max_batch: int = 8                # decode lanes per step
    token_budget: int = 32            # per-step chunked-prefill budget
    chunk_buckets: Tuple[int, ...] = (8, 16, 32)   # padded prefill shapes
    # batched chunked prefill: up to this many lanes fuse into ONE
    # data-plane dispatch (padded to the next lane bucket; padding lanes
    # write to the garbage page and are masked out of the MoE statistics)
    max_prefill_lanes: int = 8
    lane_buckets: Tuple[int, ...] = (1, 2, 4, 8)   # padded batch shapes
    theta_age_s: float = 5.0
    prefix_sharing: bool = False      # ref-counted prefix cache + COW
    # decode-token caching policy (prefix_sharing only): finish-time
    # registration of prompt+generated tokens can be opted out per engine,
    # gated on a minimum sequence length, and given a TTL after which the
    # registered entries are evicted from the radix index. Mid-life
    # page-aligned prompt registration is unaffected — these knobs govern
    # only the token-granular finish-time (decode/n-gram) entries.
    register_decode_tokens: bool = True
    min_register_len: int = 0         # skip finish-time registration below
    register_ttl_s: float = 0.0       # 0 = registrations never expire
    # device page dtype: "auto" keeps the model dtype; "int8" stores
    # quantized pages + per-row fp32 scales (kernels/kv_pack) — same pool
    # bytes hold ~2*hd/(hd+4) times the tokens, dequant on read
    kv_dtype: str = "auto"
    # preemption flavor when a HostKVTier backs the pool: "recompute" |
    # "swap" | "auto" (measured SwapCostModel decides per victim)
    swap_policy: str = "recompute"
    # mixed fused steps: decode lanes join prefill lanes in single
    # cost-aware grouped model dispatches (models/transformer.py::
    # mixed_step_paged) instead of one decode call + per-group prefill
    # calls. Off keeps the split-dispatch path (the A/B baseline).
    mixed_steps: bool = False
    # fixed cost the mixed grouper charges per dispatch, in token
    # equivalents (kernel launch + MoE weight streaming): higher values
    # fuse more aggressively, trading (B, S) padding for fewer calls
    dispatch_overhead_tokens: int = 16
    # where the runner's params, page pool and kernels live: "cuda" runs
    # the CUDA kernels, "cpu" their plain PyTorch versions
    device: str = "cuda"

    @property
    def max_len(self) -> int:
        """Per-request KV capacity in tokens."""
        return self.page_size * self.max_blocks_per_req


class PagedModelRunner:
    """The paged-model entry points, shared across a cluster's engines.

    Runs on ``ecfg.device``; ``params`` must already live there. There is no
    compile cache: PyTorch runs eagerly, and the ``(B, S)`` buckets only
    bound the shapes the kernels see and feed the padding counters.
    """

    def __init__(self, cfg, params, ecfg: PagedEngineConfig, *,
                 n_sources: int, ragged_dispatch: Optional[bool] = None):
        if cfg.input_mode != "tokens":
            raise NotImplementedError("paged runtime serves token models")
        self.device = torch.device(ecfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PagedModelRunner: device 'cuda' requested "
                               "but no CUDA device is available; pass "
                               "PagedEngineConfig(device='cpu') to run the "
                               "plain CPU versions")
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"PagedModelRunner: params live on "
                                 f"{leaf.device}, runner on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.n_sources = n_sources
        # MoE dispatch of every call this runner makes: the sort-based
        # ragged path (default) or the capacity-padded one
        self.ragged_dispatch = ragged_dispatch is not False
        # (B, S)-bucket padding accounting across every dispatch this
        # runner serves: padded minus real tokens. The cost-aware mixed
        # grouper exists to push waste down; the bench reads these.
        self.padding_waste_tokens = 0
        self.padded_tokens_total = 0

    def _count_padding(self, padded: int, real: int) -> None:
        self.padded_tokens_total += padded
        self.padding_waste_tokens += padded - real

    def decode(self, tokens, pages, lengths, block_tables, active,
               placement, source_ids, *, real: int):
        """``real``: the active lanes, counted by the caller on the host
        (the padding counters read no device tensor)."""
        self._count_padding(int(tokens.shape[0]), real)
        return tfm.decode_step_paged(
            self.params, self.cfg, tokens, pages, lengths,
            block_tables=block_tables, active=active, placement=placement,
            source_ids=source_ids, n_sources=self.n_sources,
            collect_stats=self.cfg.moe.enabled, ragged=self.ragged_dispatch)

    def prefill_chunk(self, batch, pages, block_tables, placement,
                      source_ids, *, real: int):
        """``real``: the sum of ``chunk_lens``, from the caller's host
        array."""
        B, S = (int(batch["tokens"].shape[0]), int(batch["tokens"].shape[1]))
        self._count_padding(B * S, real)
        return tfm.prefill_chunk_paged(
            self.params, self.cfg, batch, pages, block_tables=block_tables,
            placement=placement, source_ids=source_ids,
            n_sources=self.n_sources, collect_stats=self.cfg.moe.enabled,
            ragged=self.ragged_dispatch)

    def mixed_step(self, batch, pages, block_tables, placement, source_ids,
                   *, real: int):
        """One fused mixed-group dispatch (decode + prefill lanes);
        ``real`` as for :meth:`prefill_chunk`."""
        B, S = (int(batch["tokens"].shape[0]), int(batch["tokens"].shape[1]))
        self._count_padding(B * S, real)
        return tfm.mixed_step_paged(
            self.params, self.cfg, batch, pages, block_tables=block_tables,
            placement=placement, source_ids=source_ids,
            n_sources=self.n_sources, collect_stats=self.cfg.moe.enabled,
            ragged=self.ragged_dispatch)

    def bucket_for(self, chunk: int) -> int:
        for b in self.ecfg.chunk_buckets:
            if chunk <= b:
                return b
        return self.ecfg.chunk_buckets[-1]

    def mixed_bucket_for(self, chunk: int) -> int:
        """Padded S for a mixed dispatch — the planner's grouping cost
        uses the same function, so priced and physical shapes agree."""
        return mixed_chunk_bucket(chunk, self.ecfg.chunk_buckets)

    def lane_bucket_for(self, n_lanes: int) -> int:
        """Padded batch size for a fused prefill dispatch of ``n_lanes``."""
        for b in self.ecfg.lane_buckets:
            if n_lanes <= b:
                return b
        # unreachable when engines respect the constructor check
        # (max_prefill_lanes <= lane_buckets[-1]); silently padding DOWN
        # would drop lanes' block-table rows, so fail loudly instead
        raise ValueError(
            f"{n_lanes} prefill lanes exceed the largest lane bucket "
            f"{self.ecfg.lane_buckets[-1]}")

    def init_pages(self):
        return tfm.init_paged_cache(self.cfg, self.ecfg.n_pages + 1,
                                    self.ecfg.page_size,
                                    kv_dtype=self.ecfg.kv_dtype,
                                    device=self.device)


class PagedRealEngine:
    """One DP replica serving the real model from the paged KV runtime."""

    def __init__(self, engine_id: int, cfg, params,
                 ecfg: Optional[PagedEngineConfig] = None, *,
                 runner: Optional[PagedModelRunner] = None,
                 n_sources: int = 2,
                 ragged_dispatch: Optional[bool] = None,
                 tier: Optional[HostKVTier] = None):
        self.engine_id = engine_id
        self.cfg = cfg
        self.ecfg = ecfg or PagedEngineConfig()
        self.runner = runner or PagedModelRunner(
            cfg, params, self.ecfg, n_sources=n_sources,
            ragged_dispatch=ragged_dispatch)
        # a shared runner owns the physical page arrays' shape: this
        # engine's allocator must never hand out ids past them (a smaller
        # pool over a bigger runner is fine — the bench's tight run)
        assert self.ecfg.page_size == self.runner.ecfg.page_size, \
            "engine/runner page_size mismatch"
        assert self.ecfg.n_pages <= self.runner.ecfg.n_pages, \
            "engine pool larger than the runner's physical page arrays"
        assert self.ecfg.max_prefill_lanes \
            <= self.runner.ecfg.lane_buckets[-1], \
            "engine fuses more prefill lanes than the runner's lane buckets"
        assert self.ecfg.kv_dtype == self.runner.ecfg.kv_dtype, \
            "engine/runner kv_dtype mismatch"
        self.sharing = self.ecfg.prefix_sharing
        self.tier = tier
        self.pool = self._make_pool()
        self.pages = self.runner.init_pages()
        if tier is not None and tier.page_nbytes == 0:
            tier.page_nbytes = tfm.paged_cache_page_nbytes(self.pages)
        # measured swap-vs-recompute pricing (tiered engines only): the
        # save/load callbacks and the data-plane dispatches feed it
        self.swap_cost = SwapCostModel() if tier is not None else None
        self._swap_in_bytes_window = 0.0
        self._summary_shipper = PrefixSummaryShipper(self.pool) \
            if self.sharing else None
        self.prefix_hit_tokens = 0        # prefill tokens skipped via cache
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.finished: List[Request] = []
        self.qcfg = QueueConfig(theta_age_s=self.ecfg.theta_age_s)
        self.planner = StepPlanner(
            PlannerConfig(token_budget=self.ecfg.token_budget,
                          max_running=self.ecfg.max_batch,
                          chunk_cap=self.ecfg.chunk_buckets[-1],
                          lanes_per_dispatch=self.ecfg.max_prefill_lanes,
                          sharing=self.sharing,
                          swap_policy=self.ecfg.swap_policy,
                          mixed_steps=self.ecfg.mixed_steps,
                          lane_buckets=self.ecfg.lane_buckets,
                          chunk_buckets=self.ecfg.chunk_buckets,
                          dispatch_overhead_tokens=(
                              self.ecfg.dispatch_overhead_tokens)),
            self.pool, self,
            order_waiting=lambda w, now: order_queue(w, now, self.qcfg),
            preempt_one=self._preempt_one,
            apply_copies=self._apply_cow,
            swap_cost=self.swap_cost)
        self.placement = tfm.identity_placement(cfg).numpy()
        self.moe_pressure: float = 0.0
        self.stats_log: List[Dict] = []
        self.step_count = 0
        self.n_stalled_total = 0
        self._stalled_last = 0
        # fault-tolerance lifecycle (ft/): dead = crashed/fenced/released
        # (no stepping, no traces); draining = no admissions, residents
        # finish, then release() leaves the fleet
        self.dead = False
        self.draining = False
        self.n_failures = 0
        # per-step telemetry (mirrors DPEngine for the harness/bench)
        self.total_prefill_tokens = 0
        self.total_decode_tokens = 0
        self.prefill_dispatches = 0       # fused prefill/mixed model calls
        self.prefill_lanes_total = 0      # real lanes across those calls
        self.decode_dispatches = 0        # split decode model calls (0 in
                                          # mixed mode — decode lanes ride
                                          # the fused dispatches)
        self.swap_in_blocked_total = 0    # head-of-line swap-ins the pool
        self._swap_in_blocked_last = 0    # could not back (tiered pools)

    # ---- pool / tier plumbing --------------------------------------------
    def _make_pool(self):
        if self.tier is not None:
            return TieredSharedAllocator(
                self.ecfg.n_pages, self.ecfg.page_size, tier=self.tier,
                save_pages=self._save_pages, load_pages=self._load_pages,
                archive_prefixes=self.sharing)
        if self.sharing:
            return SharedPagedAllocator(self.ecfg.n_pages,
                                        self.ecfg.page_size)
        return PagedBlockAllocator(self.ecfg.n_pages, self.ecfg.page_size)

    def _save_pages(self, page_ids: List[int]):
        """Device -> host copy of whole page rows (the tier's payload),
        timed into the swap cost model's d2h bandwidth estimate."""
        t0 = time.perf_counter()
        payload = tree_map(lambda t: t.to("cpu"),
                           tfm.gather_pages(self.pages, page_ids))
        if self.swap_cost is not None:
            self.swap_cost.observe_transfer(
                len(page_ids) * self.tier.page_nbytes,
                time.perf_counter() - t0, kind="out")
        return payload

    def _load_pages(self, payload, page_ids: List[int]) -> None:
        """Host -> device restore into freshly allocated page rows."""
        t0 = time.perf_counter()
        self.pages = tfm.scatter_pages(self.pages, payload, page_ids)
        self._sync()
        if self.swap_cost is not None:
            self.swap_cost.observe_transfer(
                len(page_ids) * self.tier.page_nbytes,
                time.perf_counter() - t0, kind="in")

    # ---- host <-> device ---------------------------------------------------
    def _dev(self, arr) -> torch.Tensor:
        """A host array as a tensor on the runner's device."""
        return torch.as_tensor(np.asarray(arr), device=self.runner.device)

    def _source_ids(self, B: int) -> torch.Tensor:
        return torch.full((B,), self.engine_id, dtype=torch.int32,
                          device=self.runner.device)

    def _sync(self) -> None:
        if self.runner.device.type == "cuda":
            torch.cuda.synchronize(self.runner.device)

    # ---- admission -------------------------------------------------------
    def enqueue(self, req: Request, now: float) -> None:
        if (req.prefill_done > 0 or req.generated > 0) and not (
                self.tier is not None
                and self.tier.holds_request(req.req_id)):
            # progress without tier backing (mixed fleet, or a foreign
            # tier): fold emitted tokens into a resume prompt instead of
            # pretending KV this engine cannot restore exists
            req.export_for_resume()
        req.engine_id = self.engine_id
        req.dispatch_time = now
        counting.event("request.enqueue", req=req.req_id,
                       engine=self.engine_id)
        # the full trajectory (prompt + every decode write) must fit both
        # the block table (max_len) and the pool, or the output would be
        # silently truncated by the capacity backstop in _run_decode
        total = req.prompt_len + req.max_new_tokens
        if total > self.ecfg.max_len or \
                self.pool.blocks_for(total, self.ecfg.page_size) \
                > self.ecfg.n_pages:
            # reject instead of overflowing the block table: a lone admitted
            # request must always be able to run to completion
            req.state = RequestState.FINISHED
            req.error = "prompt_exceeds_kv_capacity"
            req.finish_time = now
            self.finished.append(req)
            return
        req.state = RequestState.WAITING
        self.waiting.append(req)

    # ---- fault-tolerance lifecycle ---------------------------------------
    def _reset_pool(self) -> None:
        """Replace the allocator with a fresh, empty one (the physical
        arrays keep their storage — stale contents are unreachable once
        every block table is gone). Lifetime stat counters carry over so
        cluster telemetry stays cumulative across restarts."""
        old = self.pool
        if isinstance(old, TieredSharedAllocator):
            # the radix index dies with the pool: drop its parked prefix
            # pages from the tier (request-level entries survive — their
            # payloads are host copies any tier-sharing engine can restore)
            old.drop_index()
        self.pool = self._make_pool()
        for k, v in vars(old).items():
            if k.startswith("stat_"):
                setattr(self.pool, k, v)
        self.planner.pool = self.pool
        if self.sharing:
            self._summary_shipper = PrefixSummaryShipper(self.pool)

    def fail(self, now: float = 0.0) -> List[Request]:
        """Crash (or fence a presumed-dead engine): the KV pool is lost.

        Every resident and queued request is exported for re-dispatch —
        already-emitted tokens folded into a resume prompt
        (:meth:`Request.export_for_resume`), so a healthy engine
        re-prefills prompt+emitted and continues the token stream exactly
        under deterministic decode. Idempotent: a second call on a dead
        engine only drains requests enqueued since (a dispatch that raced
        the failure detection), without resetting the pool again."""
        exported = list(self.running) + list(self.waiting)
        self.running.clear()
        self.waiting.clear()
        for r in exported:
            if self.tier is not None and self.tier.holds_request(r.req_id):
                # swapped-out victim: its pages live in host memory, which
                # survives the crash — keep prefill/decode progress; any
                # engine sharing the tier swaps it back in at admission
                r.state = RequestState.WAITING
                r.engine_id = -1
                r.n_recoveries += 1
            else:
                r.export_for_resume()
        if not self.dead:
            self.n_failures += 1
            self._reset_pool()
            self.dead = True
        self.draining = False
        return exported

    def drain(self, now: float = 0.0) -> List[Request]:
        """Graceful scale-in, phase 1: stop admitting. The local queue is
        exported for re-dispatch (those requests hold no KV yet); residents
        keep running to completion. The caller watches ``has_work`` and
        calls :meth:`release` once the last resident finishes."""
        self.draining = True
        exported = list(self.waiting)
        self.waiting.clear()
        for r in exported:
            r.export_for_resume()
        if self.tier is not None:
            # swap-based drain: residents' pages move to the host tier and
            # the requests export WITH their progress — re-dispatch costs a
            # transfer instead of a re-prefill (recovery_recompute_tokens
            # stays ~0). Residents the tier cannot take drain classically
            # (keep running here until finished).
            for r in list(self.running):
                written = written_kv_len(r)
                rec = self.pool.swap_out_request(r.req_id, written) \
                    if written > 0 else None
                if rec is None and written > 0:
                    continue               # tier full: classic drain
                self.running.remove(r)
                if rec is None:            # nothing written: free restart
                    self.pool.free(r.req_id)
                    r.export_for_resume()
                else:
                    r.state = RequestState.WAITING
                    r.engine_id = -1
                    r.n_recoveries += 1
                exported.append(r)
        return exported

    def release(self) -> None:
        """Graceful scale-in, phase 2: residents are done — free the pool
        and leave the fleet (dead until a restart/scale-up re-adds it)."""
        assert not self.running and not self.waiting, \
            "release() before the drain finished"
        self._reset_pool()
        self.dead = True
        self.draining = False

    def restart(self) -> None:
        """Rejoin after fail()/release(): fresh empty pool (reset at death),
        no residents. The control plane re-admits on the first fresh trace
        and the prefix-summary resync path rebuilds the affinity signal."""
        self.dead = False
        self.draining = False

    def _preempt_one(self, protect: Optional[Request] = None) -> bool:
        """Evict the latest-arrived request (recompute mode): reclaim its
        pages and push it back through the queue."""
        victim = select_preemption_victim(self.running, protect)
        if victim is None:
            return False
        self.running.remove(victim)
        self.pool.free(victim.req_id)
        victim.prefill_done = 0
        victim.generated = 0
        victim.output_tokens = []
        victim.n_preemptions += 1
        victim.state = RequestState.PREEMPTED
        self.waiting.append(victim)
        return True

    def _apply_cow(self, copies) -> None:
        self.pages = tfm.copy_pages(self.pages, copies)

    def _finish(self, r: Request, now: float) -> None:
        r.state = RequestState.FINISHED
        r.finish_time = now
        self.running.remove(r)
        if self.sharing and r.prompt_tokens:
            # register everything the pages actually hold — prompt AND
            # generated tokens, token-granular including the partial tail
            # (the newest sampled token's KV is never written, hence the
            # written_kv_len cap) — so future prompts continuing this
            # request's n-gram stream hit past the original prompt. Done
            # only at finish: these pages take no further writes, so
            # indexing them cannot trigger COW churn. Policy knobs: the
            # opt-out falls back to prompt-only registration,
            # min_register_len gates the finish-time entry out entirely
            # (measured on the sequence actually registered, after the
            # opt-out truncation), register_ttl_s stamps an expiry the
            # allocator sweeps.
            seq = list(r.prompt_tokens)
            if self.ecfg.register_decode_tokens:
                seq += list(r.output_tokens or [])
            seq = seq[:written_kv_len(r)]
            if len(seq) >= self.ecfg.min_register_len:
                ttl = self.ecfg.register_ttl_s
                self.pool.register_prefix(
                    r.req_id, seq,
                    expires_at=(now + ttl) if ttl > 0 else None)
        self.pool.free(r.req_id)
        self.finished.append(r)

    # ---- one plan/execute step --------------------------------------------
    def step(self, now: float) -> List[Request]:
        """One continuous-batching step: the :class:`StepPlanner` makes all
        control decisions (admission, growth/COW, preemption, token-budget
        packing into fused lane groups); this method only executes the
        declarative plan on the data plane."""
        if self.dead:
            return []
        with counting.span("engine.step", engine=self.engine_id) as sp:
            before = self._step_counts() if sp else None
            with counting.span("engine.plan"):
                if self.sharing and self.ecfg.register_ttl_s > 0:
                    self.pool.expire_registrations(now)
                plan = self.planner.plan(now)
                self.prefix_hit_tokens += plan.prefix_hit_tokens
                self._stalled_last = plan.n_stalled
                self.n_stalled_total += plan.n_stalled
                self._swap_in_blocked_last = plan.swap_in_blocked
                self.swap_in_blocked_total += plan.swap_in_blocked
                self._swap_in_bytes_window += sum(rec.nbytes
                                                  for rec in plan.swap_in)

            finished: List[Request] = []
            if plan.mixed_groups:
                finished.extend(self._run_mixed(plan, now))
            else:
                for group in plan.prefill_groups:
                    finished.extend(self._run_prefill_group(group, now))
                if plan.decode:
                    finished.extend(self._run_decode(plan.decode, now))
            if plan.has_work:
                self.step_count += 1
            if sp:
                after = self._step_counts()
                sp.set(round=counting.inherited("round"), **{
                    k: b - a for k, a, b in zip(
                        ("prefill_tokens", "decode_lanes", "dispatches",
                         "padded_tokens", "real_tokens"), before, after)})
        return finished

    def _step_counts(self):
        """The counters an ``engine.step`` span reports the deltas of."""
        rn = self.runner
        return (self.total_prefill_tokens, self.total_decode_tokens,
                self.prefill_dispatches + self.decode_dispatches,
                rn.padded_tokens_total,
                rn.padded_tokens_total - rn.padding_waste_tokens)

    @staticmethod
    def _first_token(r: Request, tok: int, now: float) -> None:
        r.output_tokens = [tok]
        r.generated = 1
        if r.first_token_time < 0:   # a resumed request's client saw
            r.first_token_time = now  # its first token before the crash
            counting.event("request.first_token", req=r.req_id)

    # ---- data-plane calls ------------------------------------------------
    def _run_prefill_group(self, group: List[PrefillLane],
                           now: float) -> List[Request]:
        """One fused B-lane chunked-prefill dispatch. Lanes are padded to
        the runner's (B, S) bucket; padding lanes get all-garbage block
        tables and zero chunk_lens, so their rows write to page 0, attend
        to nothing and are masked out of the MoE statistics."""
        with counting.span("engine.prepare"):
            S = self.runner.bucket_for(max(l.chunk for l in group))
            B = self.runner.lane_bucket_for(len(group))
            toks = np.zeros((B, S), np.int32)
            starts = np.zeros(B, np.int32)
            lens = np.zeros(B, np.int32)
            rids: List[Optional[int]] = [None] * B
            for i, l in enumerate(group):
                toks[i, :l.chunk] = \
                    l.req.prompt_tokens[l.start:l.start + l.chunk]
                starts[i] = l.start
                lens[i] = l.chunk
                rids[i] = l.req.req_id
            batch = {"tokens": self._dev(toks),
                     "chunk_starts": self._dev(starts),
                     "chunk_lens": self._dev(lens)}
            bt = self._dev(self.pool.block_table_array(
                rids, self.ecfg.max_blocks_per_req))
            t0 = time.perf_counter()
            placement, src = self._dev(self.placement), self._source_ids(B)
        with counting.span("model.launch", kind="prefill") as sp:
            if sp:
                sp.set(reqs=rids[:len(group)], shape=(B, S))
            logits, self.pages, stats = self.runner.prefill_chunk(
                batch, self.pages, bt, placement, src, real=int(lens.sum()))
            nxt = torch.argmax(logits, dim=-1)
        with counting.span("engine.wait"):
            nxt = nxt.cpu().numpy()  # sync point
        with counting.span("engine.readback"):
            if self.swap_cost is not None:
                self.swap_cost.observe_prefill(sum(l.chunk for l in group),
                                               time.perf_counter() - t0)
            self.prefill_dispatches += 1
            self.prefill_lanes_total += len(group)
            if stats is not None:
                self.stats_log.append(_stats_to_numpy(stats))
        finished = []
        with counting.span("engine.apply"):
            for i, l in enumerate(group):
                r = l.req
                r.prefill_done += l.chunk
                self.total_prefill_tokens += l.chunk
                if self.sharing:
                    # full pages just completed become shareable (first
                    # writer wins). Mid-life registration is floored to the
                    # page boundary: indexing the in-progress partial page
                    # would force a COW on the very next chunk/decode write
                    # into it — the token-granular tail is registered once
                    # at finish.
                    full = r.prefill_done \
                        - r.prefill_done % self.ecfg.page_size
                    self.pool.register_prefix(r.req_id,
                                              r.prompt_tokens[:full])
                if r.remaining_prefill == 0:
                    self._first_token(r, int(nxt[i]), now)
                    if r.done:
                        self._finish(r, now)
                        finished.append(r)
        return finished

    def _dispatch_mixed_group(self, group: List[PrefillLane]) -> Dict[int, int]:
        """One fused mixed dispatch: pad the group's decode + prefill
        lanes to the runner's mixed (B, S) bucket (S=1 when the group is
        all decode) and run ``mixed_step_paged``. Returns req_id -> the
        argmax next token of each lane's chunk-end logits; effect
        application is the caller's job (canonical split order)."""
        with counting.span("engine.prepare"):
            S = self.runner.mixed_bucket_for(max(l.chunk for l in group))
            B = self.runner.lane_bucket_for(len(group))
            toks = np.zeros((B, S), np.int32)
            starts = np.zeros(B, np.int32)
            lens = np.zeros(B, np.int32)
            dmask = np.zeros(B, bool)
            rids: List[Optional[int]] = [None] * B
            for i, l in enumerate(group):
                if l.decode:
                    toks[i, 0] = l.req.output_tokens[-1]
                else:
                    toks[i, :l.chunk] = \
                        l.req.prompt_tokens[l.start:l.start + l.chunk]
                starts[i] = l.start
                lens[i] = l.chunk
                dmask[i] = l.decode
                rids[i] = l.req.req_id
            batch = {"tokens": self._dev(toks),
                     "chunk_starts": self._dev(starts),
                     "chunk_lens": self._dev(lens),
                     "decode_mask": self._dev(dmask)}
            bt = self._dev(self.pool.block_table_array(
                rids, self.ecfg.max_blocks_per_req))
            t0 = time.perf_counter()
            placement, src = self._dev(self.placement), self._source_ids(B)
        real = int(lens.sum())
        with counting.span("model.launch", kind="mixed") as sp:
            if sp:
                sp.set(reqs=rids[:len(group)], shape=(B, S))
            logits, self.pages, stats = self.runner.mixed_step(
                batch, self.pages, bt, placement, src, real=real)
            nxt = torch.argmax(logits, dim=-1)
        with counting.span("engine.wait"):
            nxt = nxt.cpu().numpy()  # sync point
        with counting.span("engine.readback"):
            if self.swap_cost is not None:
                self.swap_cost.observe_prefill(real, time.perf_counter() - t0)
            self.prefill_dispatches += 1
            self.prefill_lanes_total += len(group)
            if stats is not None:
                self.stats_log.append(_stats_to_numpy(stats))
        return {l.req.req_id: int(nxt[i]) for i, l in enumerate(group)}

    def _run_mixed(self, plan: StepPlan, now: float) -> List[Request]:
        """Execute a mixed-step plan: dispatch every fused group, then
        apply per-request effects in the canonical SPLIT order (prefill
        lanes in packing order, then decode lanes) — prefix-cache
        registration and finish order thus match the split path exactly,
        which the mixed/split differential tests rely on. Sound because
        each request appears in at most one lane and COW happened at
        plan time, so dispatch order cannot change any lane's output."""
        next_tok: Dict[int, int] = {}
        for group in plan.mixed_groups:
            next_tok.update(self._dispatch_mixed_group(group))
        finished: List[Request] = []
        with counting.span("engine.apply"):
            for l in plan.prefill_lanes:
                r = l.req
                r.prefill_done += l.chunk
                self.total_prefill_tokens += l.chunk
                if self.sharing:
                    full = r.prefill_done \
                        - r.prefill_done % self.ecfg.page_size
                    self.pool.register_prefix(r.req_id,
                                              r.prompt_tokens[:full])
                if r.remaining_prefill == 0:
                    self._first_token(r, next_tok[r.req_id], now)
                    if r.done:
                        self._finish(r, now)
                        finished.append(r)
            for r in plan.decode:
                r.output_tokens.append(next_tok[r.req_id])
                r.generated += 1
                self.total_decode_tokens += 1
                if r.done or written_kv_len(r) + 1 >= self.ecfg.max_len:
                    self._finish(r, now)
                    finished.append(r)
        return finished

    def _run_decode(self, decode_reqs: List[Request],
                    now: float) -> List[Request]:
        B = self.ecfg.max_batch
        lanes = decode_reqs[:B]
        with counting.span("engine.prepare"):
            tokens = np.zeros(B, np.int32)
            lengths = np.zeros(B, np.int32)
            active = np.zeros(B, bool)
            rids: List[Optional[int]] = [None] * B
            for i, r in enumerate(lanes):
                tokens[i] = r.output_tokens[-1]
                lengths[i] = written_kv_len(r)
                active[i] = True
                rids[i] = r.req_id
            bt = self.pool.block_table_array(rids,
                                             self.ecfg.max_blocks_per_req)
            t0 = time.perf_counter()
            args = (self._dev(tokens), self.pages, self._dev(lengths),
                    self._dev(bt), self._dev(active),
                    self._dev(self.placement), self._source_ids(B))
        with counting.span("model.launch", kind="decode") as sp:
            if sp:
                sp.set(reqs=rids[:len(lanes)], shape=(B, 1))
            logits, self.pages, stats = self.runner.decode(*args,
                                                           real=len(lanes))
            nxt = torch.argmax(logits, dim=-1)
        with counting.span("engine.wait"):
            nxt = nxt.cpu().numpy()  # sync point
        with counting.span("engine.readback"):
            self.decode_dispatches += 1
            if self.swap_cost is not None:
                self.swap_cost.observe_decode(time.perf_counter() - t0)
            if stats is not None:
                self.stats_log.append(_stats_to_numpy(stats))
        finished = []
        with counting.span("engine.apply"):
            for i, r in enumerate(lanes):
                r.output_tokens.append(int(nxt[i]))
                r.generated += 1
                self.total_decode_tokens += 1
                if r.done or written_kv_len(r) + 1 >= self.ecfg.max_len:
                    self._finish(r, now)
                    finished.append(r)
        return finished

    # ---- control-plane surface -------------------------------------------
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
            # radix-cache digest (the scheduler's prefix-affinity signal):
            # full on first emit / requested resync, a delta otherwise
            prefix_summary=self._summary_shipper.emit(
                full=full_prefix_summary) if self.sharing else None,
            timestamp=now,
        )

    def window_stats(self):
        """Accumulated (B, A) since last call — feeds the coordinator."""
        return drain_window_stats(self.stats_log)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)
