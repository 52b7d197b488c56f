"""The port's workload generators and scenario harness against the
reference's: one-shot BurstGPT-shaped traces, multi-turn sessions, load-shape
retiming, the scenario registry, the real-plane slices, and the simulated
scenario runs with their invariant pack. All of it is seeded numpy in both
packages, so every field must be equal."""
import dataclasses
import enum

import numpy as np
import pytest

from repro.workloads import burstgpt as jburst
from repro.workloads import scenarios as jscen
from repro.workloads import sessions as jsess
from repro_torch.workloads import burstgpt as tburst
from repro_torch.workloads import scenarios as tscen
from repro_torch.workloads import sessions as tsess

from test_torch_simulator import plain

# the dashboard's wall-clock entries differ between any two runs
WALL_KEYS = ("wall_s", "build_s", "requests_per_wall_s")


def fields(r):
    """A request's every field, enums by name."""
    return {f.name: (getattr(r, f.name).name
                     if isinstance(getattr(r, f.name), enum.Enum)
                     else getattr(r, f.name))
            for f in dataclasses.fields(r)}


def assert_same_requests(t, j):
    assert len(t) == len(j) > 0
    for tr, jr in zip(t, j):
        assert fields(tr) == fields(jr), jr.req_id


def test_distributions_are_the_same():
    assert tburst.DISTRIBUTIONS == jburst.DISTRIBUTIONS


@pytest.mark.parametrize("burstiness", [1.0, 2.5])
@pytest.mark.parametrize("dist", jburst.DISTRIBUTIONS)
def test_generate_trace_matches_reference(dist, burstiness):
    kw = dict(rps=12.0, seed=4, mean_output=96, burstiness=burstiness)
    assert_same_requests(tburst.generate_trace(dist, 500, **kw),
                         jburst.generate_trace(dist, 500, **kw))
    np.testing.assert_array_equal(tburst.length_cdf(dist, n=2000, seed=2),
                                  jburst.length_cdf(dist, n=2000, seed=2))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mean_turns=1.0, max_turns=1, base_prompt=(150, 320)),
    dict(mean_turns=6.0, max_turns=10, fold_assistant=False, vocab=1000,
         think_time_s=0.5),
], ids=["default", "oneshot", "long_unfolded"])
def test_generate_sessions_matches_reference(kw):
    t = tsess.generate_sessions(300, 3.0, tsess.SessionConfig(**kw), seed=9,
                                start_id=7)
    j = jsess.generate_sessions(300, 3.0, jsess.SessionConfig(**kw), seed=9,
                                start_id=7)
    assert_same_requests(t, j)
    assert plain(tsess.session_stats(t)) == plain(jsess.session_stats(j))


@pytest.mark.parametrize("kind", ["constant", "ramp", "diurnal",
                                  "zipf_burst"])
def test_retime_arrivals_matches_reference(kind):
    arr = np.cumsum(np.random.default_rng(3).exponential(0.1, 2000))
    t = tscen.retime_arrivals(arr, tscen.LoadShape(kind=kind), seed=5)
    j = jscen.retime_arrivals(arr, jscen.LoadShape(kind=kind), seed=5)
    np.testing.assert_array_equal(t, j)
    assert t.shape == arr.shape and (np.diff(t) >= 0).all()


def test_scenario_registries_are_the_same():
    assert list(tscen.SCENARIOS) == list(jscen.SCENARIOS)
    assert len(tscen.SCENARIOS) == 6
    for name, js in jscen.SCENARIOS.items():
        ts = tscen.get_scenario(name)
        assert plain(dataclasses.asdict(ts)) == \
            plain(dataclasses.asdict(js)), name
        assert plain(dataclasses.asdict(ts.system_cfg())) == \
            plain(dataclasses.asdict(js.system_cfg())), name
        assert plain(dataclasses.asdict(ts.engine_cfg())) == \
            plain(dataclasses.asdict(js.engine_cfg())), name
    with pytest.raises(KeyError):
        tscen.get_scenario("no_such_scenario")


@pytest.mark.parametrize("fold", [None, False])
@pytest.mark.parametrize("name", list(jscen.SCENARIOS))
def test_build_real_slice_matches_reference(name, fold):
    kw = dict(seed=13, vocab=151936, max_prompt=1008, rps=2.0,
              fold_assistant=fold)
    t = tscen.build_real_slice(tscen.SCENARIOS[name], 40, **kw)
    j = jscen.build_real_slice(jscen.SCENARIOS[name], 40, **kw)
    assert_same_requests(t, j)
    assert all(0 < r.prompt_len <= 1008 for r in t)
    assert_same_requests(tscen.SCENARIOS[name].build(200, seed=2),
                         jscen.SCENARIOS[name].build(200, seed=2))


@pytest.mark.parametrize("name", list(jscen.SCENARIOS))
def test_run_scenario_dashboard_matches_reference(name):
    tdash, tres = tscen.run_scenario(tscen.SCENARIOS[name], 300, seed=3)
    jdash, jres = jscen.run_scenario(jscen.SCENARIOS[name], 300, seed=3)
    for k in WALL_KEYS:
        assert tdash.pop(k) >= 0 and k in jdash
        jdash.pop(k)
    assert plain(tdash) == plain(jdash)
    assert tdash["invariants_ok"] and tdash["n_requests"] == 300
    assert [(r.req_id, r.finish_time) for r in tres.requests] == \
        [(r.req_id, r.finish_time) for r in jres.requests]
