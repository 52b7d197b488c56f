"""The port's simulated plane against the reference's: ``simulate`` for every
system of ``PAPER_SYSTEMS`` on the same seeded traces, a session trace on the
prefix-sharing engines, the seeded source→expert routing model, and the
offline placement reference with its (beta, gamma) calibration. All of it is
numpy in both packages, so every number must be equal, not close."""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import minlp as jminlp
from repro.core.placement import PlacementConfig as JPlacement
from repro.core.placement import default_distance_matrix
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import PAPER_SYSTEMS as J_SYSTEMS
from repro.serving import SourceExpertTraffic as JTraffic
from repro.serving import simulate as j_simulate
from repro.workloads import SessionConfig as JSessionConfig
from repro.workloads import generate_sessions as j_sessions
from repro.workloads import generate_trace as j_trace
from repro_torch.core import (CalibrationResult, anneal_layer,
                              brute_force_layer, calibrate, solve_reference)
from repro_torch.core.placement import PlacementConfig as TPlacement
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import PAPER_SYSTEMS as T_SYSTEMS
from repro_torch.serving import SourceExpertTraffic as TTraffic
from repro_torch.serving import simulate as t_simulate
from repro_torch.workloads import SessionConfig as TSessionConfig
from repro_torch.workloads import generate_sessions as t_sessions
from repro_torch.workloads import generate_trace as t_trace


def plain(x):
    """Signals as plain Python values (numpy scalars and arrays unwrapped),
    with NaN made comparable."""
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def assert_same_result(j, t):
    assert len(t.requests) == len(j.requests)
    for jr, tr in zip(j.requests, t.requests):
        assert tr.req_id == jr.req_id
        assert (tr.engine_id, tr.first_token_time, tr.finish_time) == \
            (jr.engine_id, jr.first_token_time, jr.finish_time), tr.req_id
        assert (tr.ttft, tr.tpot) == (jr.ttft, jr.tpot), tr.req_id
    assert t.duration_s == j.duration_s
    assert sorted(t.signals) == sorted(j.signals)
    for k in j.signals:
        assert plain(t.signals[k]) == plain(j.signals[k]), k
    assert (t.mean_ttft, t.p99_ttft, t.mean_tpot, t.throughput) == \
        (j.mean_ttft, j.p99_ttft, j.mean_tpot, j.throughput)


def test_the_registries_are_the_same():
    assert list(T_SYSTEMS) == list(J_SYSTEMS)
    assert len(T_SYSTEMS) == 11
    for name in J_SYSTEMS:
        assert plain(dataclasses.asdict(T_SYSTEMS[name])) == \
            plain(dataclasses.asdict(J_SYSTEMS[name])), name


@pytest.mark.parametrize("dist", ["random", "two_end"])
@pytest.mark.parametrize("system", list(J_SYSTEMS))
def test_simulate_matches_reference(system, dist):
    kw = dict(rps=4.0, seed=3, mean_output=64)
    j = j_simulate(j_trace(dist, 200, **kw), J_SYSTEMS[system],
                   traffic_seed=3)
    t = t_simulate(t_trace(dist, 200, **kw), T_SYSTEMS[system],
                   traffic_seed=3)
    assert_same_result(j, t)
    assert sum(r.finish_time > 0 for r in t.requests) > 0


def test_session_trace_with_prefix_sharing_matches_reference():
    kw = dict(mean_turns=4.0, max_turns=8, think_time_s=2.0)
    j = j_simulate(j_sessions(200, 2.0, JSessionConfig(**kw), seed=5),
                   J_SYSTEMS["gimbal"],
                   engine_cfg=JEngineConfig(prefix_sharing=True),
                   traffic_seed=5)
    t = t_simulate(t_sessions(200, 2.0, TSessionConfig(**kw), seed=5),
                   T_SYSTEMS["gimbal"],
                   engine_cfg=TEngineConfig(prefix_sharing=True),
                   traffic_seed=5)
    assert_same_result(j, t)
    assert t.signals["decisions"]["affinity_path"] > 0


@pytest.mark.parametrize("shift", [0, 500])
def test_routing_model_samples_match_reference(shift):
    j = JTraffic(4, 16, 2, seed=11, shift_every_tokens=shift)
    t = TTraffic(4, 16, 2, seed=11, shift_every_tokens=shift)
    np.testing.assert_array_equal(t.pref, j.pref)
    for step in range(40):
        src, tokens = step % 2, 7 + 13 * step
        t.maybe_drift()
        j.maybe_drift()
        np.testing.assert_array_equal(t.sample_counts(src, tokens, 2),
                                      j.sample_counts(src, tokens, 2))
    np.testing.assert_array_equal(t.pref, j.pref)
    assert t.n_shifts == j.n_shifts


def _windows(seed, L=3, E=8, S=2, G=4):
    tr = JTraffic(L, E, S, seed=seed)
    rng = np.random.default_rng(seed)
    A = rng.poisson(tr.pref * 500).astype(np.float64)
    B = A.sum(axis=1)
    D = default_distance_matrix(S, G)
    prev = np.stack([np.arange(E) // (E // G)] * L)
    return B, A, D, prev


def test_placement_reference_solvers_match_reference():
    B, A, D, prev = _windows(2)
    kw = dict(mig_cost_tokens=100.0)
    jcfg, tcfg = JPlacement(**kw), TPlacement(**kw)
    # a layer small enough to enumerate
    b6, a6, d2 = B[0, :6], A[0, :, :6], default_distance_matrix(2, 2)
    np.testing.assert_array_equal(
        brute_force_layer(b6, a6, d2, None, tcfg),
        jminlp.brute_force_layer(b6, a6, d2, None, jcfg))
    np.testing.assert_array_equal(
        anneal_layer(B[1], A[1], D, prev[1], tcfg, iters=500, seed=4),
        jminlp.anneal_layer(B[1], A[1], D, prev[1], jcfg, iters=500,
                            seed=4))
    np.testing.assert_array_equal(
        solve_reference(B, A, D, prev, tcfg, iters=800, seed=3),
        jminlp.solve_reference(B, A, D, prev, jcfg, iters=800, seed=3))


def test_calibration_matches_reference():
    B, A, D, prev = _windows(7)
    grid = dict(betas=[0.0, 1e-3, 5e-2], gammas=[0.0, 0.5, 2.0], seed=1)
    t = calibrate(B, A, D, prev, ref_cfg=TPlacement(mig_cost_tokens=200.0),
                  **grid)
    j = jminlp.calibrate(B, A, D, prev,
                         ref_cfg=JPlacement(mig_cost_tokens=200.0), **grid)
    assert isinstance(t, CalibrationResult)
    assert (t.beta, t.gamma, t.agreement, t.comm_excess) == \
        (j.beta, j.gamma, j.agreement, j.comm_excess)
    assert plain(t.grid) == plain(j.grid)
    assert len(t.grid) == 9 and 0.0 <= t.agreement <= 1.0
