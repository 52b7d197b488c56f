"""Multi-engine real cluster: the Gimbal control plane over real engines.

Mirrors ``serving/simulator.py``'s loop shape — pressure-aware dispatch
(Algorithm 1) against live traces, async trace reporting, windowed A/B
statistics into the coordinator, expert migration, MoE-pressure feedback —
but every engine is a *real* data plane (``PagedRealEngine`` or the legacy
``RealModelEngine``): real forward passes, real router statistics, real KV
allocator state behind every trace signal.

Time is virtual (``dt`` per cluster round) so runs are deterministic and
wall-clock independent; each round steps every engine once — the real
analogue of the simulator's event loop at a fixed step cadence.

Fault tolerance (ft/): the loop survives engine crash, drain, stragglers
and trace loss. An :class:`~repro_torch.ft.health.EngineHealthMonitor` watches
trace staleness; a silent engine is excluded and *fenced* (presumed dead
IS dead — its resident work is exported rather than left to race a
re-dispatch), and the exported requests re-dispatch to healthy engines
through Algorithm 1 with their already-emitted tokens folded into resume
prompts, so continuations are token-exact under deterministic decode.
Re-dispatch retries back off (capped) and quarantine poison requests; when
no engine can take work, admissions are *shed* with an explicit per-request
error instead of livelocking to ``max_rounds``. A declarative
:class:`~repro_torch.ft.faults.FaultPlan` makes any chaos schedule a
reproducible test case.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.coordinator import CoordinatorConfig, GimbalCoordinator
from repro_torch.core.forecast import ForecastConfig, PrefetchConfig
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.scheduler import (BaselineScheduler, GimbalScheduler,
                                  SchedulerConfig)
from repro_torch.core.traces import TraceTable
from repro_torch.ft.elastic import ElasticController
from repro_torch.ft.faults import FaultInjector, FaultPlan
from repro_torch.ft.health import EngineHealthMonitor, HealthConfig
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.simulator import SimResult


@dataclasses.dataclass(frozen=True)
class RealClusterConfig:
    dp_scheduler: str = "gimbal"      # gimbal | round_robin | least_requests
    feedback: bool = True             # MoE pressure -> DP scheduler
    n_ranks: int = 4
    window_tokens: int = 400          # profiling window (real tokens)
    dt: float = 0.05                  # virtual seconds per cluster round
    max_rounds: int = 20_000
    scheduler_cfg: Optional[SchedulerConfig] = None
    # placement calibration: default (None) uses the paper's calibrated
    # greedy, whose 1e4-token migration cost means smoke-scale windows
    # rarely migrate; pass e.g. PlacementConfig.uncalibrated() to force
    # rebalancing at small scale (tests/demos)
    placement_cfg: Optional[PlacementConfig] = None
    # ---- predictive placement (core/forecast.py) -------------------------
    # predictive: rebalance against the forecaster's next-window traffic.
    # prefetch: stage the target placement's weights as a DOUBLE BUFFER
    # (migrate_params_for_placement is functional, so staged and serving
    # params coexist) and adopt via pointer swap once the modeled copy
    # lands — the serving path never pays the migration.
    predictive: bool = False
    prefetch: bool = False
    forecast_cfg: Optional[ForecastConfig] = None
    prefetch_cfg: Optional[PrefetchConfig] = None
    # ---- fault tolerance -------------------------------------------------
    health_cfg: Optional[HealthConfig] = None   # None -> HealthConfig()
    fault_plan: Optional[FaultPlan] = None      # deterministic chaos schedule
    # re-dispatch of requests exported off failed/drained engines: each
    # failed attempt (no healthy engine) doubles the retry backoff up to
    # the cap; past max_retries the request is quarantined with an explicit
    # error instead of spinning the loop
    redispatch_max_retries: int = 4
    redispatch_backoff_rounds: int = 2
    redispatch_backoff_cap_rounds: int = 16
    max_recoveries: int = 5           # poison guard: exports past this
                                      # quarantine instead of re-dispatching
    # graceful degradation: when EVERY healthy engine reports kv_usage at
    # or above shed_kv, admissions hold (backpressure); a request held past
    # shed_patience_s virtual seconds after arrival is shed with an error
    shed_kv: float = 0.97
    shed_patience_s: float = 10.0
    # livelock watchdog (opt-in): after this many consecutive rounds with
    # zero global progress (no tokens, no finishes, no dispatches), error
    # out every unfinished request instead of spinning to max_rounds
    stall_abort_rounds: int = 0
    # ---- control-plane checkpoints (ft/checkpoint.py) --------------------
    snapshot_every_rounds: int = 0    # 0 = off
    snapshot_path: Optional[str] = None
    restore_from: Optional[str] = None


def _save_cluster_state(path: str, sched, coord, table: TraceTable,
                        rounds: int) -> None:
    from repro_torch.ft.checkpoint import save_serving_state
    if coord is not None:
        assign = coord.placement.assign
        B, A = coord.profiler.snapshot(reset=False)
    else:
        assign = np.zeros((1, 1), np.int64)
        B, A = np.zeros((1, 1), np.int64), np.zeros((1, 1, 1), np.int64)
    save_serving_state(path, placement_assign=assign, profiler_B=B,
                       profiler_A=A,
                       scheduler_comp=dict(getattr(sched, "_comp", {})),
                       traces=table.scalar_snapshot(), step=rounds)


def _restore_cluster_state(path: str, sched, coord,
                           table: TraceTable) -> None:
    from repro_torch.ft.checkpoint import (restore_serving_extra,
                                     restore_serving_state)
    tree, comp = restore_serving_state(path)
    if hasattr(sched, "_comp"):
        sched._comp.update(comp)
    if coord is not None:
        assign = np.asarray(tree["placement_assign"])
        if assign.shape == coord.placement.assign.shape:
            coord.placement.assign[:] = assign
        B = np.asarray(tree["profiler_B"])
        A = np.asarray(tree["profiler_A"])
        if B.shape == coord.profiler._B.shape:
            coord.profiler._B[:] = B
        if A.shape == coord.profiler._A.shape:
            coord.profiler._A[:] = A
    snap = restore_serving_extra(path).get("traces")
    if snap:
        # only engines present in THIS fleet (elastic restart may differ)
        table.restore_scalars({e: s for e, s in snap.items()
                               if int(e) in table.engine_ids})


def serve_real_cluster(requests: List[Request], engines, *,
                       cluster_cfg: Optional[RealClusterConfig] = None,
                       metrics=None) -> SimResult:
    """Serve ``requests`` on N real engines under the Gimbal control plane.

    Engines must share one model config/params (they are DP replicas).
    Returns a :class:`SimResult` (same metrics surface as the simulator)
    with cluster signals in ``.signals``. ``metrics`` (a
    ``core.metrics.StreamingMetrics``) is fed every non-error finish as
    it happens — same streaming-percentile hook as the simulator.
    """
    cc = cluster_cfg or RealClusterConfig()
    mcfg = engines[0].cfg
    n_engines = len(engines)
    by_id = {e.engine_id: e for e in engines}
    table = TraceTable([e.engine_id for e in engines])
    if cc.dp_scheduler == "gimbal":
        sched = GimbalScheduler(table, cc.scheduler_cfg)
    else:
        sched = BaselineScheduler(table, cc.dp_scheduler)

    moe = mcfg.moe.enabled
    coord = None
    if moe:
        pf_cfg = cc.prefetch_cfg
        if cc.prefetch and pf_cfg is None:
            from repro_torch.models.transformer import expert_weight_bytes
            pf_cfg = PrefetchConfig(
                bytes_per_expert=float(expert_weight_bytes(mcfg)))
        coord = GimbalCoordinator(
            mcfg.n_moe_layers, mcfg.moe.n_experts, cc.n_ranks, n_engines,
            cfg=CoordinatorConfig(window_tokens=cc.window_tokens,
                                  feedback=cc.feedback,
                                  predictive=cc.predictive,
                                  prefetch=cc.prefetch,
                                  forecast_cfg=cc.forecast_cfg,
                                  prefetch_cfg=pf_cfg),
            placement_cfg=cc.placement_cfg)
    if cc.restore_from:
        _restore_cluster_state(cc.restore_from, sched, coord, table)

    pending = sorted(requests, key=lambda r: (r.arrival_time, r.req_id))
    now, rounds, migrations = 0.0, 0, 0
    kv_peak = 0.0
    cur_perms = np.asarray(engines[0].placement)

    # ---- fault-tolerance state -------------------------------------------
    injector = FaultInjector(cc.fault_plan) if cc.fault_plan else None
    orphans: List[Request] = []         # exported, awaiting re-dispatch
    retry_at: Dict[int, int] = {}       # req_id -> earliest re-dispatch round
    crash_exports: Dict[int, List[Request]] = {}   # limbo until detection
    recovered = 0                       # requests successfully re-dispatched
    recovery_recompute_tokens = 0       # re-prefilled prompt+emitted tokens
    shed = 0
    quarantined = 0
    drained_engines: List[int] = []
    drain_swapped: Dict[int, int] = {}  # engine -> residents exported via tier
    stall_streak = 0

    def quarantine(r: Request, reason: str) -> None:
        nonlocal quarantined
        r.error = reason
        r.state = RequestState.FINISHED
        r.finish_time = now
        quarantined += 1
        # a quarantined request never re-admits: release any KV pages it
        # parked in a host tier, or the tier leaks host capacity
        for e in engines:
            pool = getattr(e, "pool", None)
            if pool is not None and hasattr(pool, "drop_swapped"):
                pool.drop_swapped(r.req_id)

    def on_engine_down(eid: int) -> int:
        """Health-monitor callback: collect the dead engine's exported
        requests — and FENCE an engine that is merely unreachable (its
        silent residents would otherwise race their own re-dispatch)."""
        moved = crash_exports.pop(eid, [])
        e = by_id[eid]
        if hasattr(e, "fail"):
            moved = moved + e.fail(now)   # idempotent: drains limbo enqueues
        orphans.extend(moved)
        return len(moved)

    mon = EngineHealthMonitor(table, sched, cc.health_cfg or HealthConfig(),
                              redispatch=on_engine_down)
    # placement shape is kept fixed across membership changes (rank set
    # stays physical); the controller wires table/scheduler membership only
    ec = ElasticController(table, sched, coordinator=None)

    staged: Optional[Dict] = None      # double-buffered prefetch state
    pointer_swaps = 0                  # placements adopted without migrating

    def stage_prefetch(plan, target_perms) -> None:
        """``coord.on_prefetch``: start the asynchronous weight copy — build
        the params tree every holder will need under the staged placement,
        next to (not in place of) the live tree. The serving path keeps
        using the old buffer; :func:`apply_placement` pointer-swaps once
        the coordinator's modeled transfer lands."""
        nonlocal staged
        del plan
        from repro_torch.models.transformer import stage_expert_prefetch
        target = np.asarray(target_perms)
        bufs: Dict[int, object] = {}
        for e in engines:
            holder = getattr(e, "runner", e)
            if id(holder) not in bufs:
                bufs[id(holder)] = stage_expert_prefetch(
                    holder.params, mcfg, cur_perms, target)
        staged = {"perms": target, "base": cur_perms.copy(), "params": bufs}

    def apply_placement(new_perms: np.ndarray) -> None:
        """Adopting a placement means MOVING the weights: permute every
        param holder's stacked expert weights (once per holder — paged
        engines may share one runner), then hand engines the new table.
        When a staged prefetch buffer matches the target (and was built
        against the placement still serving), adoption is a pointer swap."""
        nonlocal cur_perms, staged, pointer_swaps
        from repro_torch.models.transformer import migrate_params_for_placement
        if staged is not None and np.array_equal(staged["perms"], new_perms) \
                and np.array_equal(staged["base"], cur_perms):
            for e in engines:
                holder = getattr(e, "runner", e)
                buf = staged["params"].get(id(holder))
                holder.params = buf if buf is not None else \
                    migrate_params_for_placement(
                        holder.params, mcfg, cur_perms, new_perms)
                e.placement = new_perms
            cur_perms = new_perms
            staged = None
            pointer_swaps += 1
            return
        staged = None              # stale buffer: fall back to a live move
        seen = set()
        for e in engines:
            holder = getattr(e, "runner", e)   # runner (paged) or engine
            if id(holder) not in seen:
                seen.add(id(holder))
                holder.params = migrate_params_for_placement(
                    holder.params, mcfg, cur_perms, new_perms)
            e.placement = new_perms
        cur_perms = new_perms

    if coord is not None and cc.prefetch:
        coord.on_prefetch = stage_prefetch

    def report_trace(e) -> None:
        # delta-based prefix digests: ship a full summary only when the
        # table lost the chain (first report, engine restart, scheduler
        # include()) — steady-state traces carry deltas
        table.report(e.trace(now, full_prefix_summary=table.needs_resync(
            e.engine_id)), now=now)
        if hasattr(sched, "on_trace_refresh"):
            sched.on_trace_refresh(e.engine_id)

    # per-engine drained-finish watermark for the streaming metrics hook
    # (engine restarts keep their finished list, so watermarks only grow;
    # min() guards a future engine type that truncates it)
    fin_seen: Dict[int, int] = {e.engine_id: 0 for e in engines}

    def drain_finishes() -> None:
        if metrics is None:
            return
        for e in engines:
            fl = getattr(e, "finished", None)
            if fl is None:
                continue
            seen = min(fin_seen[e.engine_id], len(fl))
            for r in fl[seen:]:
                if not r.error:
                    metrics.observe_request(r)
            fin_seen[e.engine_id] = len(fl)

    def progress_marker():
        return (len(pending), len(orphans),
                sum(len(v) for v in crash_exports.values()),
                sum(e.total_prefill_tokens + e.total_decode_tokens
                    for e in engines),
                sum(len(e.finished) for e in engines
                    if hasattr(e, "finished")))

    # engines announce themselves before the first round: staleness
    # detection needs a birth timestamp (a crash before the first report
    # must still be detectable) and Algorithm 1 starts from real — empty —
    # state instead of the incomplete-trace fallback
    for e in engines:
        report_trace(e)

    def is_dead(e) -> bool:
        return getattr(e, "dead", False)

    while (pending or orphans or crash_exports
           or any(e.has_work for e in engines)) and rounds < cc.max_rounds:
        # ---- 1. scheduled faults (deterministic chaos) -------------------
        if injector is not None:
            for eid in injector.crashes(rounds):
                e = by_id[eid]
                if not is_dead(e):
                    crash_exports.setdefault(eid, []).extend(e.fail(now))
            for eid in injector.recoveries(rounds):
                e = by_id[eid]
                if is_dead(e):
                    e.restart()
                    # exports never detected (quick recovery) re-dispatch
                    # now — the restarted engine lost its pool regardless
                    orphans.extend(crash_exports.pop(eid, []))
                    if eid not in table.engine_ids:   # drained: rejoin
                        ec.scale_up(eid, now)
            for eid in injector.drains(rounds):
                e = by_id[eid]
                if not is_dead(e) and not getattr(e, "draining", False):
                    sched.exclude(eid)
                    moved = e.drain(now)
                    tier = getattr(e, "tier", None)
                    if tier is not None:
                        drain_swapped[eid] = sum(
                            1 for r in moved
                            if tier.holds_request(r.req_id))
                    orphans.extend(moved)
            for e in engines:
                if hasattr(e, "pool"):
                    e.pool.force_alloc_fail = injector.alloc_fail(
                        e.engine_id, rounds)

        # drain completion: residents finished -> release pool, leave fleet
        for e in engines:
            if getattr(e, "draining", False) and not e.has_work:
                e.release()
                drained_engines.append(e.engine_id)
                if e.engine_id in table.engine_ids:
                    ec.scale_down(e.engine_id, now, drain=lambda _: 0,
                                  swapped=drain_swapped.pop(e.engine_id, 0))
                mon.unhealthy.discard(e.engine_id)

        # ---- 2. dispatch arrivals due by now (Algorithm 1 against live
        # traces; prompt ids let the scheduler score prefix affinity
        # against the engines' radix-cache summaries). Under cluster-wide
        # hard KV pressure or an empty fleet, admissions HOLD (FIFO) and
        # eventually shed with an explicit error — never a crash, never a
        # dispatch onto a dead engine, never a silent livelock.
        while pending and pending[0].arrival_time <= now:
            r = pending[0]
            healthy = sched.healthy_engines()
            traces = [table.get(e) for e in healthy]
            pressured = bool(traces) and all(
                t is not None and t.kv_usage >= cc.shed_kv for t in traces)
            if not healthy or pressured:
                if now - r.arrival_time >= cc.shed_patience_s:
                    pending.pop(0)
                    quarantine(r, "shed_no_healthy_engine" if not healthy
                               else "shed_kv_pressure")
                    shed += 1
                    continue
                break          # hold: retry next round (FIFO, no bypass)
            eid = sched.select_engine(r.prompt_len, now,
                                      prompt_tokens=r.prompt_tokens)
            if eid is None:    # raced an exclusion inside this round
                break
            pending.pop(0)
            by_id[eid].enqueue(r, now)

        # ---- 3. re-dispatch recovered requests (capped backoff) ----------
        if orphans:
            still: List[Request] = []
            for r in orphans:
                if r.n_recoveries > cc.max_recoveries:
                    quarantine(r, "poison_request")   # kills every host
                    continue
                if retry_at.get(r.req_id, 0) > rounds:
                    still.append(r)
                    continue
                eid = sched.select_engine(r.prompt_len, now,
                                          prompt_tokens=r.prompt_tokens)
                if eid is None:
                    r.redispatch_attempts += 1
                    if r.redispatch_attempts > cc.redispatch_max_retries:
                        quarantine(r, "redispatch_exhausted")
                        continue
                    backoff = min(
                        cc.redispatch_backoff_rounds
                        * 2 ** (r.redispatch_attempts - 1),
                        cc.redispatch_backoff_cap_rounds)
                    retry_at[r.req_id] = rounds + backoff
                    still.append(r)
                    continue
                by_id[eid].enqueue(r, now)
                if not r.error:            # target may reject at enqueue
                    recovered += 1
                    # tokens this request will prefill again: tier-backed
                    # exports keep prefill_done (swap-in re-attaches their
                    # pages, ~0 recompute); resume exports reset it at
                    # enqueue, so the folded prompt counts in full
                    recovery_recompute_tokens += max(
                        r.prompt_len - r.prefill_done, 0)
            orphans = still

        # ---- 4. step the data planes + collect traces --------------------
        for e in engines:
            if is_dead(e):
                continue       # no steps, no traces: staleness will tell
            straggling = injector is not None and injector.skip_step(
                e.engine_id, rounds)
            if not straggling:
                e.step(now)
            if not (injector is not None
                    and injector.drop_trace(e.engine_id, rounds)):
                report_trace(e)
            kv_peak = max(kv_peak, e.pool.usage) \
                if hasattr(e, "pool") else kv_peak
            if coord is not None:
                B, A = e.window_stats()
                if B is not None:
                    coord.profiler.record_step(
                        B, A, n_tokens=int(B.sum())
                        // max(mcfg.n_moe_layers, 1)
                        // max(mcfg.moe.top_k, 1))

        drain_finishes()

        # ---- 5. health: exclude+fence stale engines, rejoin fresh ones ---
        mon.check(now)

        if coord is not None:
            migrated, _dur = coord.maybe_rebalance(now)
            if migrated:
                migrations += 1
            if coord.poll_prefetch(now):
                migrations += 1    # a flip is still a placement adoption
            perms = np.asarray(coord.placement.permutations())
            if not np.array_equal(perms, cur_perms):
                apply_placement(perms)
            if coord._last_rank_load.sum() > 0:
                for e in engines:
                    e.moe_pressure = coord.engine_moe_pressure(e.engine_id)

        # ---- 6. livelock watchdog (opt-in) -------------------------------
        if cc.stall_abort_rounds > 0:
            marker = progress_marker()
            if rounds > 0 and marker == last_marker:
                stall_streak += 1
                if stall_streak >= cc.stall_abort_rounds:
                    for e in engines:
                        if hasattr(e, "fail") and e.has_work:
                            orphans.extend(e.fail(now))
                    for r in (orphans + pending
                              + [q for v in crash_exports.values()
                                 for q in v]):
                        quarantine(r, "cluster_livelock")
                    orphans, pending = [], []
                    crash_exports.clear()
                    break
            else:
                stall_streak = 0
            last_marker = marker
        elif rounds == 0:
            last_marker = progress_marker()

        # ---- 7. periodic control-plane snapshot --------------------------
        if cc.snapshot_every_rounds > 0 and cc.snapshot_path \
                and rounds > 0 and rounds % cc.snapshot_every_rounds == 0:
            _save_cluster_state(cc.snapshot_path, sched, coord, table,
                                rounds)

        now += cc.dt
        rounds += 1

    drain_finishes()
    # rejected/shed/quarantined requests (error set) must not pollute the
    # latency metrics: their first_token_time may be -1, which would read
    # as a negative TTFT. They stay visible via signals["errors"]/counts.
    res = SimResult(name=f"real_cluster_{cc.dp_scheduler}",
                    requests=[r for r in requests if not r.error],
                    duration_s=now, engines=list(engines))
    errors = {r.req_id: r.error for r in requests if r.error}
    res.signals = {
        "rounds": rounds,
        "migrations": migrations,
        "expert_moves": coord.placement.n_migrations if coord else 0,
        "preemptions": sum(r.n_preemptions for r in requests),
        "stalled": sum(getattr(e, "n_stalled_total", 0) for e in engines),
        # head-of-line swap-ins the pool could not back (tiered pools):
        # tier pressure Algorithm 1 would otherwise misread as ordinary
        # full-pool stalls
        "swap_in_blocked": sum(getattr(e, "swap_in_blocked_total", 0)
                               for e in engines),
        "kv_peak": kv_peak,
        # ---- fault-tolerance telemetry. Per-request errors are surfaced
        # verbatim so degraded runs are truthful: enqueue rejections, shed
        # admissions and quarantined recoveries are all visible, and
        # "unfinished" counts anything the loop abandoned at max_rounds.
        "errors": errors,
        "rejected": sum(1 for r in requests
                        if r.error and not r.error.startswith("shed_")
                        and r.error not in ("poison_request",
                                            "redispatch_exhausted",
                                            "cluster_livelock")),
        "shed_requests": shed,
        "quarantined": quarantined,
        "unfinished": sum(1 for r in requests
                          if r.state is not RequestState.FINISHED),
        "n_failures": sum(getattr(e, "n_failures", 0) for e in engines),
        "recovered_requests": recovered,
        "recovery_recompute_tokens": recovery_recompute_tokens,
        "drained_engines": drained_engines,
        # ---- KV tier telemetry (kv_tier.py; zeros when no tier). Engines
        # may share one HostKVTier, so tier-level byte/page stats dedupe by
        # object identity; the per-allocator swap counters sum per engine.
        "swapped_tokens": sum(
            t.swapped_tokens for t in {
                id(t): t for t in (getattr(e, "tier", None) for e in engines)
                if t is not None}.values()),
        "swap_out_bytes": sum(
            t.stat_out_bytes for t in {
                id(t): t for t in (getattr(e, "tier", None) for e in engines)
                if t is not None}.values()),
        "swap_in_bytes": sum(
            t.stat_in_bytes for t in {
                id(t): t for t in (getattr(e, "tier", None) for e in engines)
                if t is not None}.values()),
        "swapped_out_reqs": sum(
            getattr(getattr(e, "pool", None), "stat_swapped_out_reqs", 0)
            for e in engines),
        "swapped_in_reqs": sum(
            getattr(getattr(e, "pool", None), "stat_swapped_in_reqs", 0)
            for e in engines),
        "health_events": list(mon.events),
        "elastic_events": list(ec.log),
        # prefix-sharing telemetry (0 when sharing is off). Deliberately
        # direct attribute access: every engine type declares
        # ``prefix_hit_tokens`` (and every pool the stat_* counters), so a
        # refactor that drops the field fails loudly here instead of a
        # getattr default silently zeroing that engine out of the sum.
        "prefix_hit_tokens": sum(e.prefix_hit_tokens for e in engines),
        "per_engine_prefix_hits": {e.engine_id: e.prefix_hit_tokens
                                   for e in engines},
        "pages_allocated": sum(e.pool.stat_blocks_allocated
                               for e in engines if hasattr(e, "pool")),
        "cow_copies": sum(e.pool.stat_cow_copies
                          for e in engines if hasattr(e, "pool")),
        # token-granular vs page-aligned cache hits (radix-tree gain)
        "hit_tokens": sum(e.pool.stat_hit_tokens
                          for e in engines if hasattr(e, "pool")),
        "hit_tokens_page_aligned": sum(e.pool.stat_hit_tokens_page
                                       for e in engines
                                       if hasattr(e, "pool")),
        # batched-prefill telemetry (StepPlanner packing): fused prefill
        # data-plane dispatches and mean lanes per dispatch. Direct
        # attribute access on purpose — every engine type declares the
        # counters, so a refactor that drops them fails loudly here.
        "prefill_dispatches": sum(e.prefill_dispatches for e in engines),
        "prefill_lanes_per_dispatch": (
            sum(e.prefill_lanes_total for e in engines)
            / max(sum(e.prefill_dispatches for e in engines), 1)),
        # split decode model calls (0 when every engine runs mixed fused
        # steps); prefill_dispatches + decode_dispatches = total model
        # dispatches, the mixed-vs-split A/B headline
        "decode_dispatches": sum(getattr(e, "decode_dispatches", 0)
                                 for e in engines),
        "decisions": getattr(sched, "decisions", {}),
        "per_engine": {e.engine_id: sum(1 for r in requests
                                        if r.engine_id == e.engine_id
                                        and r.state is RequestState.FINISHED
                                        and not r.error)
                       for e in engines},
        # placements adopted by pointer swap (prefetched double buffer)
        # instead of a serving-path weight move
        "prefetch_pointer_swaps": pointer_swaps,
    }
    if coord is not None:
        res.signals.update(coord.placement_signals())
    if metrics is not None:
        res.signals["metrics"] = metrics.snapshot()
    return res
