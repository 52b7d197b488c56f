"""Discrete-event serving-cluster simulator (the simulated data plane).

Drives the *same* Gimbal control plane (scheduler, queue policy, profiler,
placement manager, coordinator) as the real engine, against the roofline
cost model. Supports every paper configuration: vLLM-like baseline
(round-robin/request-count + FCFS + EPLB), MoETuner-like (static offline
affinity placement), Sem-MoE-like (oracle static placement + work-balanced
routing), and all Gimbal ablations (DP / EP / All-no-collab / All).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.coordinator import CoordinatorConfig, GimbalCoordinator
from repro_torch.core.forecast import ForecastConfig, PrefetchConfig
from repro_torch.core.placement import PlacementConfig, default_distance_matrix, \
    greedy_layer_placement
from repro_torch.core.scheduler import (BaselineScheduler, GimbalScheduler,
                                  SchedulerConfig)
from repro_torch.core.traces import TraceTable
from repro_torch.serving.costmodel import CostModelConfig, EngineCostModel
from repro_torch.serving.engine import DPEngine, EngineConfig
from repro_torch.serving.request import Request
from repro_torch.serving.routing_sim import SourceExpertTraffic


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """One serving-system variant (maps to the paper's baselines/ablations)."""

    name: str = "gimbal"
    dp_scheduler: str = "gimbal"        # gimbal | round_robin | least_requests | oracle
    queue_policy: str = "sjf_aging"     # sjf_aging | fcfs
    ep_policy: str = "gimbal"           # gimbal | eplb | static_affinity | static_ilp | none
    feedback: bool = True               # MoE pressure -> DP scheduler
    placement_cfg: Optional[PlacementConfig] = None
    redundant_slots: int = 0            # beyond-paper: hot-expert replicas
    n_engines: int = 2
    n_ranks: int = 4
    n_moe_layers: int = 48
    n_experts: int = 128
    top_k: int = 8
    trace_interval_s: float = 0.05      # async engine-stats reporting period
    window_tokens: int = 40_000
    # ---- predictive placement (core/forecast.py): rebalance against the
    # forecast next window; prefetch stages the expert-weight copy off the
    # serving path and flips only once it lands (no migration stall)
    predictive: bool = False
    prefetch: bool = False
    forecast_cfg: Optional[ForecastConfig] = None
    prefetch_cfg: Optional[PrefetchConfig] = None
    # routing non-stationarity fed to SourceExpertTraffic (zipf_shift):
    # hot-expert set fully rotates every N routed tokens (0 = stationary)
    routing_shift_tokens: int = 0
    routing_shift_roll: int = 0         # 0 -> E // 8


PAPER_SYSTEMS: Dict[str, SystemConfig] = {
    "vllm": SystemConfig(name="vllm", dp_scheduler="least_requests",
                         queue_policy="fcfs", ep_policy="eplb",
                         feedback=False),
    "moetuner": SystemConfig(name="moetuner", dp_scheduler="least_requests",
                             queue_policy="fcfs",
                             ep_policy="static_affinity", feedback=False),
    "semmoe": SystemConfig(name="semmoe", dp_scheduler="oracle",
                           queue_policy="fcfs", ep_policy="static_ilp",
                           feedback=False),
    "gimbal": SystemConfig(name="gimbal"),
    "gimbal_dp": SystemConfig(name="gimbal_dp", ep_policy="eplb",
                              feedback=False),
    "gimbal_ep": SystemConfig(name="gimbal_ep", dp_scheduler="least_requests",
                              queue_policy="fcfs", feedback=False),
    "gimbal_nocollab": SystemConfig(name="gimbal_nocollab", feedback=False),
    "gimbal_uncalibrated": SystemConfig(
        name="gimbal_uncalibrated",
        placement_cfg=PlacementConfig.uncalibrated()),
    # beyond-paper: Gimbal + 4 redundant hot-expert replicas per layer
    "gimbal_replicated": SystemConfig(name="gimbal_replicated",
                                      redundant_slots=4),
    # beyond-paper: predictive placement — forecast next-window traffic,
    # rebalance toward it; "gimbal_forecast" migrates synchronously (the
    # prediction-only ablation), "gimbal_predictive" additionally hides
    # the migration behind an async expert-weight prefetch
    "gimbal_forecast": SystemConfig(name="gimbal_forecast", predictive=True),
    "gimbal_predictive": SystemConfig(name="gimbal_predictive",
                                      predictive=True, prefetch=True),
}


class EPLBPlacementPolicy:
    """Aggregate-load-only rebalancing (DeepSeek EPLB style): sort experts by
    load, snake-assign across ranks. Ignores the A matrix entirely.
    Rearranges only when the current per-rank imbalance crosses a threshold
    (vLLM-style rearrangement trigger)."""

    def __init__(self, manager, threshold: float = 1.15):
        self.manager = manager
        self.threshold = threshold

    def update(self, B, A):
        loads = self.manager.per_rank_load(B.astype(np.float64))  # (L, G)
        tot = loads.sum()
        if tot > 0:
            lsum = loads.sum(axis=1)
            valid = lsum > 0
            per_layer = loads[valid].max(axis=1) / (
                lsum[valid] / loads.shape[1])
            imb = float(np.average(per_layer,
                                   weights=np.maximum(lsum[valid], 1)))
            if imb < self.threshold:
                return []
        plan = []
        G = self.manager.G
        for l in range(B.shape[0]):
            if B[l].sum() == 0:
                continue
            order = np.argsort(-B[l])
            new = np.zeros_like(self.manager.assign[l])
            for i, e in enumerate(order):
                cyc = i % (2 * G)
                new[e] = cyc if cyc < G else 2 * G - 1 - cyc  # snake
            moved = np.flatnonzero(new != self.manager.assign[l])
            for e in moved:
                plan.append((l, int(e), int(self.manager.assign[l, e]),
                             int(new[e])))
            self.manager.assign[l] = new
        if plan:
            self.manager.n_rebalances += 1
            self.manager.n_migrations += len(plan)
        return plan


@dataclasses.dataclass
class SimResult:
    name: str
    requests: List[Request] = dataclasses.field(default_factory=list)
    duration_s: float = 0.0
    signals: Dict = dataclasses.field(default_factory=dict)
    # the engines the run used — telemetry source for the scenario
    # invariant pack (not part of the serialized result)
    engines: Optional[List] = dataclasses.field(default=None, repr=False)

    def _arr(self, fn):
        done = [r for r in self.requests if r.finish_time > 0]
        return np.asarray([fn(r) for r in done]) if done else np.zeros(1)

    @property
    def mean_ttft(self):
        return float(self._arr(lambda r: r.ttft).mean())

    @property
    def p99_ttft(self):
        return float(np.percentile(self._arr(lambda r: r.ttft), 99))

    @property
    def mean_tpot(self):
        a = self._arr(lambda r: r.tpot)
        return float(a[a > 0].mean()) if (a > 0).any() else 0.0

    @property
    def mean_e2e(self):
        return float(self._arr(lambda r: r.e2e).mean())

    @property
    def throughput(self):
        n_done = sum(1 for r in self.requests if r.finish_time > 0)
        return n_done / max(self.duration_s, 1e-9)


def simulate(requests: List[Request], system: SystemConfig, *,
             cost_cfg: Optional[CostModelConfig] = None,
             engine_cfg: Optional[EngineConfig] = None,
             traffic_seed: int = 0, horizon_s: float = 3600.0,
             metrics=None) -> SimResult:
    """``metrics`` (a ``core.metrics.StreamingMetrics``) is fed every
    non-error finish as it happens, so 10^6-request runs get streaming
    p50/p99 without holding raw latency arrays."""
    sc = system
    cost = EngineCostModel(cost_cfg or CostModelConfig(top_k=sc.top_k))
    ecfg = engine_cfg or EngineConfig()
    ecfg = dataclasses.replace(ecfg, queue_policy=sc.queue_policy)

    traffic = SourceExpertTraffic(sc.n_moe_layers, sc.n_experts, sc.n_engines,
                                  seed=traffic_seed,
                                  shift_every_tokens=sc.routing_shift_tokens,
                                  shift_roll=sc.routing_shift_roll)
    engines = [DPEngine(i, ecfg, cost, traffic, sc.top_k)
               for i in range(sc.n_engines)]
    table = TraceTable(range(sc.n_engines))

    # ---- DP scheduler
    if sc.dp_scheduler == "gimbal":
        sched = GimbalScheduler(table)
    elif sc.dp_scheduler in ("round_robin", "least_requests"):
        sched = BaselineScheduler(table, sc.dp_scheduler)
    else:
        sched = None  # oracle handled inline

    # ---- EP placement policy
    D = default_distance_matrix(sc.n_engines, sc.n_ranks)
    coord = GimbalCoordinator(
        sc.n_moe_layers, sc.n_experts, sc.n_ranks, sc.n_engines,
        cfg=CoordinatorConfig(window_tokens=sc.window_tokens,
                              feedback=sc.feedback,
                              rebalance=sc.ep_policy in
                              ("gimbal", "eplb"),
                              predictive=sc.predictive,
                              prefetch=sc.prefetch,
                              forecast_cfg=sc.forecast_cfg,
                              prefetch_cfg=sc.prefetch_cfg),
        placement_cfg=sc.placement_cfg, D=D,
        redundant_slots=sc.redundant_slots)
    eplb = EPLBPlacementPolicy(coord.placement) if sc.ep_policy == "eplb" \
        else None

    if sc.ep_policy in ("static_affinity", "static_ilp"):
        # offline profile: captured on a *different* workload window, so it
        # holds the persistent routing structure but misses the live mix —
        # the staleness the paper identifies in MoETuner/Sem-MoE (§2.3).
        stale = SourceExpertTraffic(sc.n_moe_layers, sc.n_experts,
                                    sc.n_engines, seed=traffic_seed + 777)
        pref_off = 0.35 * traffic.pref + 0.65 * stale.pref
        B_off = pref_off.sum(axis=1) * 1e6              # (L, E)
        A_off = pref_off * 1e6                          # (L, S, E)
        pc = coord.placement.cfg
        for l in range(sc.n_moe_layers):
            if sc.ep_policy == "static_affinity":
                Azero = np.zeros((sc.n_engines, sc.n_experts))
                coord.placement.assign[l] = greedy_layer_placement(
                    B_off[l], Azero, D, None,
                    PlacementConfig(alpha=0.0, beta=1.0, gamma=0.0))
            else:
                coord.placement.assign[l] = greedy_layer_placement(
                    B_off[l], A_off[l], D, None,
                    PlacementConfig(alpha=1.0, beta=pc.beta, gamma=0.0))

    # oracle (Sem-MoE) dispatch: balances total known work across engines
    oracle_load = np.zeros(sc.n_engines)

    # ---- event loop ------------------------------------------------------
    # events: (time, seq, kind, payload)
    events = []
    seq = 0
    for r in requests:
        heapq.heappush(events, (r.arrival_time, seq, "arrival", r))
        seq += 1
    heapq.heappush(events, (0.0, seq, "trace", None))
    seq += 1
    engine_busy_until = [0.0] * sc.n_engines
    engine_scheduled = [False] * sc.n_engines
    migration_until = 0.0
    now = 0.0
    samples = {"running": [], "kv": []}   # Fig. 12 runtime signals

    def refresh_backend_signals():
        load = coord._last_rank_load                     # (L, G)
        tot = load.sum()
        # Execution is per-MoE-layer: every layer's all-to-all completes when
        # its hottest rank finishes, so the step stretch is the load-weighted
        # mean over layers of (max_g / mean_g) — a GLOBAL slowdown shared by
        # the co-located engines (DP+TP+EP share chips, paper §2.2.3).
        if tot > 0:
            lsum = load.sum(axis=1)                      # (L,)
            valid = lsum > 0
            per_layer = np.ones(load.shape[0])
            per_layer[valid] = load[valid].max(axis=1) / (
                lsum[valid] / sc.n_ranks)
            imb = float(np.average(per_layer, weights=np.maximum(lsum, 1)))
        else:
            imb = 1.0
        for e in engines:
            # global per-layer imbalance + local co-located-rank contention
            # (DP+TP+EP share chips: hot local ranks steal the co-located
            # engine's compute, paper §2.2.3)
            cont = coord.engine_contention(e.engine_id)
            e.moe_imbalance = max(imb, 1.0) + 1.0 * cont
            e.moe_pressure = coord.engine_moe_pressure(e.engine_id)
        # remote fraction under current placement (per engine/source);
        # with replication, traffic routes to the NEAREST copy
        for e in engines:
            pref = traffic.pref[:, e.engine_id, :]       # (L, E)
            remote = 0.0
            for l in range(sc.n_moe_layers):
                dist = D[e.engine_id, coord.placement.assign[l]].copy()
                if coord.placement.R > 0:
                    for i in range(coord.placement.R):
                        ex = coord.placement.replica_expert[l, i]
                        g = coord.placement.replica_rank[l, i]
                        if ex >= 0 and g >= 0:
                            dist[ex] = min(dist[ex], D[e.engine_id, g])
                remote += float(pref[l][dist > 0].sum())
            e.remote_frac = remote / sc.n_moe_layers

    def kick(eng_id: int, t: float):
        nonlocal seq
        if not engine_scheduled[eng_id]:
            engine_scheduled[eng_id] = True
            heapq.heappush(events, (max(t, engine_busy_until[eng_id],
                                        migration_until), seq, "step",
                            eng_id))
            seq += 1

    fin_seen = [0] * sc.n_engines     # per-engine drained-finish watermark

    def drain_finishes():
        if metrics is None:
            return
        for i, e in enumerate(engines):
            fl = e.finished
            for r in fl[fin_seen[i]:]:
                if not r.error:
                    metrics.observe_request(r)
            fin_seen[i] = len(fl)

    refresh_backend_signals()
    while events:
        now, _, kind, payload = heapq.heappop(events)
        if now > horizon_s:
            break
        if kind == "arrival":
            r: Request = payload
            if sc.dp_scheduler == "oracle":
                work = r.prompt_len + 4.0 * r.max_new_tokens
                eid = int(np.argmin(oracle_load))
                oracle_load[eid] += work
            else:
                eid = sched.select_engine(r.prompt_len, now,
                                          prompt_tokens=r.prompt_tokens)
                # the simulator never excludes engines, so a None (empty
                # fleet) return cannot happen on a well-formed SystemConfig
                assert eid is not None, "simulator fleet is empty"
            engines[eid].enqueue(r, now)
            kick(eid, now)
        elif kind == "trace":
            for e in engines:
                table.report(e.trace(now, full_prefix_summary=table.
                                     needs_resync(e.engine_id)), now=now)
                if sched is not None and hasattr(sched, "on_trace_refresh"):
                    sched.on_trace_refresh(e.engine_id)
            if any(e.has_work for e in engines):
                samples["running"].append(
                    np.mean([len(e.running) for e in engines]))
                samples["kv"].append(np.mean([e.pool.usage for e in engines]))
            if any(e.has_work for e in engines) or events:
                heapq.heappush(events, (now + sc.trace_interval_s, seq,
                                        "trace", None))
                seq += 1
        elif kind == "step":
            eid = payload
            engine_scheduled[eid] = False
            if now < migration_until:
                kick(eid, migration_until)
                continue
            e = engines[eid]
            dur, routed, info = e.step(now)
            if routed is not None:
                coord.profiler.record_step(
                    routed, routed[:, None, :] *
                    (np.arange(sc.n_engines) == eid)[None, :, None],
                    n_tokens=info.get("prefill_tokens", 0)
                    + info.get("decode_tokens", 0))
                if sc.ep_policy == "eplb" and \
                        coord.profiler.window_tokens >= sc.window_tokens:
                    B, A = coord.profiler.snapshot(reset=True)
                    plan = eplb.update(B, A)
                    coord._last_rank_load = coord.placement.per_rank_load(
                        B.astype(np.float64))
                    if plan:
                        migration_until = now + dur + \
                            coord.migration_duration(len(plan))
                        coord._migrated_once = True
                    refresh_backend_signals()
                elif sc.ep_policy == "gimbal":
                    migrated, mdur = coord.maybe_rebalance(now)
                    if migrated:
                        migration_until = now + dur + mdur
                    if migrated or coord.profiler.window_tokens == 0:
                        refresh_backend_signals()
                elif coord.profiler.window_tokens >= sc.window_tokens:
                    # static policies still track load for pressure signals
                    B, _ = coord.profiler.snapshot(reset=True)
                    coord._last_rank_load = coord.placement.per_rank_load(
                        B.astype(np.float64))
                    refresh_backend_signals()
            if sc.ep_policy == "gimbal" and coord.poll_prefetch(now):
                # staged weights landed: pointer flip off the serving path
                # (flip_s > 0 models a non-free pointer swap)
                if coord.cfg.flip_s > 0:
                    migration_until = max(migration_until,
                                          now + coord.cfg.flip_s)
                refresh_backend_signals()
            drain_finishes()
            if dur > 0:
                engine_busy_until[eid] = now + dur
                kick(eid, now + dur)
            elif e.has_work:
                kick(eid, now + 0.001)

    drain_finishes()
    res = SimResult(name=sc.name, requests=requests, duration_s=now,
                    engines=engines)
    res.signals = {
        "avg_running": float(np.mean(samples["running"]))
        if samples["running"] else 0.0,
        "kv_usage": float(np.mean(samples["kv"])) if samples["kv"] else 0.0,
        "prompt_tput_gap": _prompt_tput_gap(engines),
        "migrations": coord.placement.n_migrations,
        "decisions": getattr(sched, "decisions", {}),
        "preemptions": sum(r.n_preemptions for r in requests),
        # StepPlanner packing telemetry, comparable with the real plane's
        "prefill_dispatches": sum(e.prefill_dispatches for e in engines),
        "prefill_lanes_per_dispatch": (
            sum(e.prefill_lanes_total for e in engines)
            / max(sum(e.prefill_dispatches for e in engines), 1)),
        "routing_shifts": traffic.n_shifts,
    }
    res.signals.update(coord.placement_signals())
    if metrics is not None:
        res.signals["metrics"] = metrics.snapshot()
    return res


def _prompt_tput_gap(engines) -> float:
    """Cross-engine prompt-throughput gap (tokens/s), the Fig. 12 signal."""
    rates = [e.total_prefill_tokens / max(e.busy_time, 1e-9) for e in engines]
    return float(max(rates) - min(rates)) if len(rates) > 1 else 0.0
