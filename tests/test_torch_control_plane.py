"""The port's copies of the Gimbal control plane against the reference's,
driven with the same seeded inputs in both packages: Algorithm-1 dispatch
(scheduler over a trace table), the expert profiler, source-aware greedy
placement (Algorithm 2), the coordinator's rebalance loop with forecasting
and prefetch, the health monitor and the streaming metrics. Every
selection, placement, plan, decision count and signal must be identical."""
import numpy as np
import pytest

import repro.core as J
import repro.ft as JFT
import repro_torch.core as T
import repro_torch.ft as TFT

PKGS = [(J, JFT), (T, TFT)]


def _traces(core, rng, n_engines):
    return [core.EngineTrace(
        engine_id=e,
        remaining_prefill_tokens=float(rng.integers(0, 4000)),
        waiting_prefill_tokens=float(rng.integers(0, 4000)),
        kv_usage=float(rng.uniform(0, 1)),
        moe_pressure=float(rng.uniform(0, 2)),
        n_running=int(rng.integers(0, 16)), n_waiting=int(rng.integers(0, 8)),
        n_stalled=int(rng.integers(0, 2))) for e in range(n_engines)]


def _dispatch(core, policy, seed):
    rng = np.random.default_rng(seed)
    table = core.TraceTable(list(range(4)))
    sched = (core.GimbalScheduler(table) if policy == "gimbal"
             else core.BaselineScheduler(table, policy))
    picks, now = [], 0.0
    for step in range(300):
        if step % 7 == 0 and step:           # fresh traces every few picks
            for tr in _traces(core, rng, 4):
                table.report(tr, now=now)
        if step == 150 and policy == "gimbal":
            sched.exclude(2)                 # an engine leaves and returns
        if step == 200 and policy == "gimbal":
            sched.include(2)
        picks.append(sched.select_engine(int(rng.integers(1, 3000)), now))
        now += float(rng.exponential(0.05))
    return picks, dict(getattr(sched, "decisions", {}))


@pytest.mark.parametrize("policy", ["gimbal", "round_robin",
                                    "least_requests"])
def test_dispatch_matches_reference(policy):
    (jp, jd), (tp, td) = (_dispatch(core, policy, seed=3)
                          for core, _ in PKGS)
    assert tp == jp and td == jd
    if policy == "gimbal":
        assert sum(td.values()) == 300 and td["score_path"] > 0


def _windows(rng, L, E, S, n):
    """Skewed per-source expert traffic whose hot set moves every four
    windows."""
    for w in range(n):
        hot = (np.arange(E) + 3 * (w // 4)) % E
        p = 1.0 / (1 + hot) ** 1.2
        A = np.stack([[rng.multinomial(400, np.roll(p, 5 * s) / p.sum())
                       for s in range(S)] for _ in range(L)])
        yield A.sum(axis=1), A                          # B (L, E), A


@pytest.mark.parametrize("mode", ["reactive", "predictive_prefetch"])
def test_coordinator_matches_reference(mode):
    L, E, G, S = 3, 16, 4, 2
    pred = mode == "predictive_prefetch"
    runs = []
    for core, _ in PKGS:
        coord = core.GimbalCoordinator(
            L, E, G, S,
            cfg=core.CoordinatorConfig(window_tokens=600, predictive=pred,
                                       prefetch=pred),
            placement_cfg=core.PlacementConfig.uncalibrated())
        staged, log, now = [], [], 0.0
        coord.on_prefetch = lambda plan, perms: staged.append(
            (list(plan), np.asarray(perms).tolist()))
        for B, A in _windows(np.random.default_rng(7), L, E, S, 24):
            coord.profiler.record_step(B, A, n_tokens=int(B.sum()) // L)
            # a staged prefetch lands before the next window's poll
            log.append((coord.maybe_rebalance(now),
                        coord.poll_prefetch(now + 0.25),
                        coord.placement.assign.tolist(),
                        np.asarray(coord.placement.permutations()).tolist(),
                        [coord.engine_moe_pressure(e) for e in range(S)],
                        [coord.engine_contention(e) for e in range(S)]))
            now += 0.5
        runs.append((log, staged, coord.placement_signals(),
                     coord.migration_log))
    assert runs[1] == runs[0]
    log, staged, sig, _ = runs[1]
    assert sig["n_migrations"] > 0
    if pred:
        assert staged and sig["prefetch_hits"] > 0


def test_greedy_placement_matches_reference():
    rng = np.random.default_rng(11)
    E, G, S = 32, 4, 2
    for trial in range(5):
        A = rng.integers(0, 50, (S, E)).astype(np.float64)
        B = A.sum(axis=0)
        prev = rng.integers(0, G, E)
        out = []
        for core, _ in PKGS:
            D = core.default_distance_matrix(S, G)
            for cfg in (core.PlacementConfig(),
                        core.PlacementConfig.uncalibrated()):
                assign = core.greedy_layer_placement(B, A, D, prev, cfg)
                out.append((np.asarray(assign).tolist(),
                            core.total_objective(assign, B, A, D, prev, cfg),
                            core.assignment_to_permutation(
                                np.asarray(assign), G).tolist()))
        assert out[2:] == out[:2]


def test_profiler_and_metrics_match_reference():
    rng = np.random.default_rng(5)
    steps = [(rng.integers(0, 9, (2, 8)), rng.integers(0, 5, (2, 2, 8)))
             for _ in range(6)]
    lat = rng.exponential(0.2, (500, 3))
    out = []
    for core, _ in PKGS:
        prof = core.ExpertProfiler(2, 8, 2)
        for B, A in steps:
            prof.record_step(B, A, n_tokens=int(B.sum()))
        B, A = prof.snapshot(reset=False)
        m = core.StreamingMetrics(seed=0, window_s=1.0)
        for i, (a, b, c) in enumerate(lat):
            m.observe("ttft", a, 0.01 * i)
            m.observe("e2e", a + b + c, 0.01 * i)
        out.append((B.tolist(), A.tolist(), prof.window_tokens,
                    m.snapshot(series=True)))
    assert out[1] == out[0]


def test_health_monitor_matches_reference():
    out = []
    for core, ft in PKGS:
        table = core.TraceTable([0, 1, 2])
        sched = core.GimbalScheduler(table)
        down = []
        mon = ft.EngineHealthMonitor(table, sched,
                                     ft.HealthConfig(trace_timeout_s=0.3),
                                     redispatch=lambda e: down.append(e) or 0)
        now = 0.0
        for step in range(40):
            for e in (0, 1, 2):
                silent = (e == 1 and 8 <= step < 20) or (e == 2 and step > 30)
                if not silent:
                    table.report(core.EngineTrace(engine_id=e), now=now)
            mon.check(now)
            now += 0.05
        out.append((mon.events, down, sched.healthy_engines()))
    assert out[1] == out[0]
    assert any(ev["event"] == "down" for ev in out[1][0])
