"""The span helper of ``repro_torch/counting.py``: nothing recorded and
the shared NULL while nothing records; parents, attributes, instant
events and kernel calls while recording, under ``counting.recording()``
or a ``torch.profiler`` session; the bounded buffer."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import counting


@pytest.fixture(autouse=True)
def _empty_buffer():
    counting.clear_spans()
    yield
    counting.clear_spans()


def test_nothing_records_without_a_session():
    sp = counting.span("engine.step", engine=0)
    assert sp is counting.NULL and not sp
    with counting.span("engine.plan") as inner:
        inner.set(lanes=3)
        counting.event("request.enqueue", req=1)
    assert counting.spans() == []


def test_recording_keeps_parents_attributes_and_events():
    with counting.recording():
        with counting.span("cluster.round", round=7) as r:
            assert r
            with counting.span("engine.step", engine=1) as s:
                s.set(round=counting.inherited("round"))
                counting.event("request.first_token", req=42)
                with counting.span("engine.wait"):
                    pass
            r.set(dispatched=2)
        counting.event("request.enqueue", req=43)
    got = counting.spans()
    assert [s.name for s in got] == ["cluster.round", "engine.step",
                                     "request.first_token", "engine.wait",
                                     "request.enqueue"]
    assert [s.parent for s in got] == [-1, 0, 1, 1, -1]
    assert got[0].attrs == {"round": 7, "dispatched": 2}
    assert got[1].attrs == {"engine": 1, "round": 7}
    assert got[2].start_ns == got[2].end_ns and got[2].attrs == {"req": 42}
    for child in got[1:4]:
        parent = got[child.parent]
        assert parent.start_ns <= child.start_ns <= child.end_ns \
            <= parent.end_ns
    assert counting.inherited("round") is None      # nothing open now
    assert counting.span("x") is counting.NULL      # recording ended


def test_a_kernel_region_adds_a_call_to_the_innermost_span():
    calls = []

    @counting.counted("toy_kernel", lambda x: (1, 1))
    def kernel(x):
        calls.append(x)
        return inner_kernel(x)

    @counting.counted("inner_kernel", lambda x: (1, 1))
    def inner_kernel(x):
        return x

    with counting.recording():
        with counting.span("engine.step"):
            kernel(1)
            with counting.span("model.launch"):
                kernel(2)
                kernel(3)
    kernel(4)                                        # not recording
    step, launch = counting.spans()
    assert step.kernels == {"toy_kernel": 1}         # the outermost only
    assert launch.kernels == {"toy_kernel": 2}
    assert calls == [1, 2, 3, 4]
    assert counting.state.depth == 0 and not counting.state.open


def test_a_profiler_session_records_spans_and_their_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with counting.span("engine.step", engine=0):
            with counting.span("model.launch"):
                torch.ones(4).add_(1)
    assert [s.name for s in counting.spans()] == ["engine.step",
                                                  "model.launch"]
    names = {e.name for e in prof.events()}
    assert {"engine.step", "model.launch"} <= names
    assert counting.span("x") is counting.NULL       # the session ended


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(counting, "MAX_SPANS", 3)
    with counting.recording():
        for i in range(5):
            with counting.span("s", i=i):
                counting.event("e")
    assert len(counting.spans()) == 3
    assert counting.state.dropped == 7            # 3 spans, 4 events
    assert not counting.state.open


def test_a_full_buffer_still_opens_the_profilers_range(monkeypatch):
    monkeypatch.setattr(counting, "MAX_SPANS", 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with counting.span("cluster.round"):
            with counting.span("collective:all_reduce") as sp:
                assert not sp                        # not kept
                sp.set(bytes=4)
                torch.ones(4).add_(1)
    assert [s.name for s in counting.spans()] == ["cluster.round"]
    assert counting.state.dropped == 1 and not counting.state.open
    names = {e.name for e in prof.events()}
    assert {"cluster.round", "collective:all_reduce"} <= names


def test_an_exception_closes_the_span():
    with counting.recording():
        with pytest.raises(KeyError):
            with counting.span("engine.step"):
                raise KeyError("window closed")
    (s,) = counting.spans()
    assert s.end_ns >= s.start_ns and not counting.state.open


def test_clearing_with_a_span_open_raises():
    with counting.recording(), counting.span("cluster.round"):
        with pytest.raises(RuntimeError):
            counting.clear_spans()
