"""The program's spans in the smoke-sized serve the benchmark drives, and
the readers of the ``program_span`` metrics it records itself.

One set-up serves three windows of the same seed: with nothing recording,
under ``counting.recording()`` and under a CPU ``torch.profiler`` session.
"""
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import counting
from servebench import harness, spans
from servebench.test_servebench_metrics import _reader

CELL = "qwen3moe_burst_prefill"
ROUNDS = 10
PHASES = {"engine.plan", "engine.prepare", "model.launch", "engine.wait",
          "engine.readback", "engine.apply"}
CONTROL = {"scheduler.dispatch", "cluster.step", "scheduler.report",
           "coordinator.stats", "cluster.finished", "health.check",
           "coordinator.rebalance", "coordinator.prefetch",
           "coordinator.migrate", "coordinator.pressure"}


@pytest.fixture(scope="module")
def serves():
    torch.set_num_threads(1)
    cell = harness.load_cell(CELL, size="smoke")
    t = time.perf_counter()
    prog = harness.setup_program(cell, 7, "cpu", t)
    out, padding = {}, {}
    rn = prog.runner
    for mode in ("off", "recording", "profiler"):
        counting.clear_spans()
        before = (rn.padded_tokens_total, rn.padding_waste_tokens)
        if mode == "off":
            run = harness.serve(cell, prog, 7, 1e9, False, t, ROUNDS)
        elif mode == "recording":
            with counting.recording():
                run = harness.serve(cell, prog, 7, 1e9, False, t, ROUNDS)
        else:
            with profile(activities=[ProfilerActivity.CPU]):
                run = harness.serve(cell, prog, 7, 1e9, False, t, ROUNDS)
        out[mode] = (run, counting.spans())
        padding[mode] = (rn.padded_tokens_total - before[0],
                         rn.padding_waste_tokens - before[1])
    counting.clear_spans()
    out["padding"] = padding
    return out


def test_nothing_records_and_the_outputs_do_not_move(serves):
    off, recorded = serves["off"], serves["recording"]
    assert off[1] == []
    assert recorded[1]
    for mode in ("recording", "profiler"):
        run = serves[mode][0]
        assert run.served.keys() == off[0].served.keys()
        for rid, s in off[0].served.items():
            assert run.served[rid]["output"] == s["output"], (mode, rid)
        assert [(s.round, s.engine, s.prefill_tokens, s.decode_tokens)
                for s in run.rec.steps] == \
            [(s.round, s.engine, s.prefill_tokens, s.decode_tokens)
             for s in off[0].rec.steps]


@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_spans_nest_and_count_what_the_engines_count(serves, mode):
    run, got = serves[mode]
    rec = run.rec
    children = {}
    for i, s in enumerate(got):
        if s.parent >= 0:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s.name
            children.setdefault(s.parent, []).append(s)
    steps = [(i, s) for i, s in enumerate(got) if s.name == "engine.step"]
    assert steps
    worked = 0
    for i, s in steps:
        call = got[s.parent]                 # the cluster's call of it
        assert call.name == "cluster.step"
        assert call.attrs["engine"] == s.attrs["engine"]
        parent = got[call.parent]
        assert parent.name == "cluster.round"
        assert s.attrs["round"] == parent.attrs["round"]
        names = {c.name for c in children.get(i, [])}
        if s.attrs["dispatches"]:
            worked += 1
            assert PHASES <= names, names
            launches = [c for c in children[i] if c.name == "model.launch"]
            assert len(launches) == s.attrs["dispatches"]
            assert sum(sum(c.kernels.values()) for c in launches) > 0
        else:
            assert names == {"engine.plan"}
        assert s.attrs["padded_tokens"] >= s.attrs["real_tokens"] \
            >= s.attrs["prefill_tokens"]
    assert worked
    # every control-plane span sits in a round; each kind ran
    for s in got:
        if s.name in CONTROL:
            assert got[s.parent].name == "cluster.round", s.name
    assert CONTROL <= {s.name for s in got}
    # the step spans, engine by engine, are the harness's wrapped steps:
    # each inside its wrapper's [t0, t1], with the same counts
    for e in {s.engine for s in rec.steps}:
        wrapped = [s for s in rec.steps if s.engine == e]
        mine = [s for _, s in steps if s.attrs["engine"] == e]
        assert len(mine) == len(wrapped)
        for w, s in zip(wrapped, mine):
            assert w.t0 * 1e9 <= s.start_ns and s.end_ns <= w.t1 * 1e9
            assert (s.attrs["round"], s.attrs["prefill_tokens"],
                    s.attrs["decode_lanes"]) == \
                (w.round, w.prefill_tokens, w.decode_tokens)
        # and the window's sums are the engine's own counter deltas
        a, b = rec.counters_open[e], rec.counters_close[e]
        window = [s for s in mine
                  if rec.open_round <= s.attrs["round"] < rec.close_round]
        assert sum(s.attrs["prefill_tokens"] for s in window) == b[1] - a[1]
        assert sum(s.attrs["decode_lanes"] for s in window) == b[2] - a[2]
        assert sum(s.attrs["dispatches"] > 0 for s in window) == b[0] - a[0]
    # one request, one identifier: its enqueue and its first token
    enq = {s.attrs["req"] for s in got if s.name == "request.enqueue"}
    first = {s.attrs["req"] for s in got if s.name == "request.first_token"}
    launched = {r for s in got if s.name == "model.launch"
                for r in s.attrs["reqs"]}
    assert first and first <= enq and launched <= enq
    assert {r for r, q in rec.reqs.items() if q.first_wall} <= first


@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_a_request_is_followed_from_enqueue_to_its_first_token(serves,
                                                               mode):
    """The operator's reading of a request: its enqueue, the launches
    that carried it (its queue wait ends at the first), its first token,
    which the harness sees at the end of the same step."""
    run, got = serves[mode]
    enq = {s.attrs["req"]: s for s in got if s.name == "request.enqueue"}
    first = {s.attrs["req"]: s for s in got
             if s.name == "request.first_token"}
    assert first
    for rid, f in first.items():
        launches = [s for s in got if s.name == "model.launch"
                    and rid in s.attrs["reqs"]]
        assert enq[rid].start_ns <= min(s.start_ns for s in launches)
        assert any(s.end_ns <= f.start_ns for s in launches)
        assert got[f.parent].name == "engine.apply"
        rr = run.rec.reqs.get(rid)
        if rr is not None and rr.first_wall is not None:
            assert f.start_ns <= rr.first_wall * 1e9


@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_the_step_spans_carry_the_runners_padding(serves, mode):
    """``padded_tokens`` and ``real_tokens`` of the step spans add up to
    the shared runner's own padding counters over the serve."""
    got = serves[mode][1]
    padded, waste = serves["padding"][mode]
    steps = [s for s in got if s.name == "engine.step"]
    assert padded > waste > 0
    assert sum(s.attrs["padded_tokens"] for s in steps) == padded
    assert sum(s.attrs["padded_tokens"] - s.attrs["real_tokens"]
               for s in steps) == waste


def test_readers_read_the_recorded_spans(serves, monkeypatch):
    run, got = serves["recording"]
    rec = run.rec
    a, b = rec.open_round + 2, rec.open_round + 6
    rec.trace_rounds = (a, b)
    rec.trace_mark, rec.trace_end = rec.round_start[a], rec.round_start[b]
    monkeypatch.setattr(counting, "spans", lambda: got)
    found = spans.traced(run)
    # a round's clock starts at its first engine call, inside its span:
    # the first round's span begins before the stretch, its steps inside
    assert found and {s.attrs["round"] for s in found.values()
                      if s.name == "cluster.round"} == set(range(a + 1, b))
    assert {s.attrs["round"] for s in found.values()
            if s.name == "engine.step"} == set(range(a, b))
    host, launch = _reader("step_host_ms")(run), _reader("step_launch_ms")(run)
    assert 0 < launch < host
    assert _reader("coordinator_ms_per_round")(run) > 0


def _span(name, t0, t1, parent=-1, **attrs):
    return counting.Span(name, int(t0 * 1e9), int(t1 * 1e9), parent, attrs)


def _synthetic(monkeypatch, coordinator=True):
    """A 4-round stretch [100, 104) s: round r holds a working step of 0.5
    s (launch 0.1, wait 0.3) and, where asked, 0.02 s of coordinator, of
    which a nested stage of 0.005 s."""
    got = []
    for r in range(4):
        t = 100.0 + r
        i = len(got)
        got.append(_span("cluster.round", t, t + 1, round=r))
        s = len(got)
        got.append(_span("engine.step", t, t + 0.5, i, dispatches=1))
        got += [_span("model.launch", t + 0.05, t + 0.15, s),
                _span("engine.wait", t + 0.15, t + 0.45, s)]
        got.append(_span("engine.step", t + 0.5, t + 0.51, i,
                         dispatches=0))
        if coordinator:
            c = len(got)
            got.append(_span("coordinator.rebalance", t + 0.6, t + 0.62, i))
            got.append(_span("coordinator.migrate", t + 0.61, t + 0.615, c))
    got.append(_span("engine.step", 104.5, 105.0, dispatches=1))  # after
    monkeypatch.setattr(counting, "spans", lambda: got)
    rec = types.SimpleNamespace(trace_mark=100.0, trace_end=104.0,
                                trace_rounds=(10, 14))
    return types.SimpleNamespace(rec=rec)


def test_readers_on_synthetic_spans(monkeypatch):
    run = _synthetic(monkeypatch)
    assert _reader("step_host_ms")(run) == pytest.approx(200.0)
    assert _reader("step_launch_ms")(run) == pytest.approx(100.0)
    assert _reader("coordinator_ms_per_round")(run) == pytest.approx(20.0)


def test_readers_give_none_without_a_coordinator_or_a_trace(monkeypatch):
    run = _synthetic(monkeypatch, coordinator=False)
    assert _reader("coordinator_ms_per_round")(run) is None
    assert _reader("step_host_ms")(run) == pytest.approx(200.0)
    run.rec.trace_mark = run.rec.trace_end = None        # not traced
    for name in ("step_host_ms", "step_launch_ms",
                 "coordinator_ms_per_round"):
        assert _reader(name)(run) is None
    # a program that records no spans
    run = _synthetic(monkeypatch)
    monkeypatch.delattr(counting, "spans")
    for name in ("step_host_ms", "step_launch_ms",
                 "coordinator_ms_per_round"):
        assert _reader(name)(run) is None
