"""The benchmark's metric arithmetic on synthetic stamps, and the trace
reduction on a synthetic profile."""
import importlib.util
import types
from pathlib import Path

import pytest

from servebench import harness, stats, trace

METRICS = Path(__file__).resolve().parent / "metrics"


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(stall_round=None, stall_s=2.0, n_rounds=40, n_req=12):
    """One engine, one step a round of 0.1 s (2 s at ``stall_round``);
    request i is due in round i, gets its first token at the end of round
    i + 1's step and one more each round until it has 10."""
    rec = harness.Recorder([], dt=0.05, open_round=0, seconds=1e9,
                           page_size=16)
    t = 0.0
    for r in range(n_rounds + 1):
        rec.round_start[r] = t
        t += stall_s if r == stall_round else 0.1
    rec.t_open, rec.open_round = 0.0, 0
    rec.t_close, rec.close_round = rec.round_start[n_rounds], n_rounds
    for i in range(n_req):
        rec.reqs[i] = harness.ReqRecord(due_round=i, prompt_len=100,
                                        due_wall=rec.round_start[i])
    for r in range(n_rounds):
        t0, t1 = rec.round_start[r] + 0.01, rec.round_start[r + 1] - 0.01
        s = harness.StepRecord(round=r, engine=0, t0=t0, t1=t1, worked=True)
        for i, q in rec.reqs.items():
            if i + 1 <= r and q.seen < 10:
                q.seen += 1
                q.window_tokens.append(t1)
                if q.first_wall is None:
                    q.first_wall, q.first_round = t1, r
                s.new_tokens += 1
                s.decode_tokens += 1
                s.decode_ctx += 100 + q.seen
                s.logits += 1
        rec.steps.append(s)
    c = harness.load_cell("qwen3moe_burst_prefill")
    cell = types.SimpleNamespace(config=c.config, arch=c.arch)
    return harness.Run(cell=cell, seed=0, device="cpu", rec=rec,
                       setup_s=1.0, served={})


def test_quantile_is_exact_order_statistics():
    assert stats.quantile([3, 1, 2], 0.5) == 2
    assert stats.quantile(range(11), 0.9) == pytest.approx(9.0)
    assert stats.quantile([1.0, 2.0], 0.5) == pytest.approx(1.5)
    assert stats.quantile([], 0.5) is None


def test_synthetic_run_reads_its_timeline():
    run = _run()
    # first token one round and a step after the due round's start
    assert _reader("ttft_p50_s")(run) == pytest.approx(0.19)
    assert _reader("tpot_p90_ms")(run) == pytest.approx(100.0)
    assert _reader("output_tok_s")(run) == pytest.approx(120 / 4.0)
    assert _reader("ttft_rounds_p90")(run) == pytest.approx(1.0)
    assert _reader("step_ms")(run) == pytest.approx(80.0)
    assert _reader("control_ms_per_round")(run) == pytest.approx(20.0)
    assert 0 < _reader("step_mfu")(run) < 100


def test_a_stall_in_the_window_moves_every_end_to_end_metric():
    base, stalled = _run(), _run(stall_round=6)
    for name in ("ttft_p90_s", "tpot_p90_ms"):
        assert _reader(name)(stalled) > _reader(name)(base), name
    assert _reader("output_tok_s")(stalled) < _reader("output_tok_s")(base)
    # a stall is wall time: the round counts of scheduling do not move
    assert _reader("ttft_rounds_p90")(stalled) \
        == _reader("ttft_rounds_p90")(base)


def test_a_request_without_a_token_counts_its_wait():
    run = _run(n_rounds=12, n_req=12)
    waits = stats.ttft_s(run)
    last = run.rec.reqs[11]
    assert last.first_wall is None
    assert waits[-1] == pytest.approx(run.rec.t_close - last.due_wall)


class _Ev:
    def __init__(self, name, a, b):
        from torch.autograd import DeviceType
        self.name, self.device_type = name, DeviceType.CUDA
        self.time_range = types.SimpleNamespace(start=a, end=b)


def test_trace_reduction_on_a_synthetic_profile():
    rec = harness.Recorder([], dt=0.05, open_round=0, seconds=1.0,
                           page_size=16)
    rec.trace_mark, rec.trace_end = 100.0, 100.010        # a 10 ms stretch
    rec.steps = [harness.StepRecord(round=0, engine=0, t0=100.0,
                                    t1=100.006, worked=True,
                                    decode_tokens=1)]
    # the marker at 5000 us; two overlapping kernels at 1 to 4 ms after
    # it, then one more at 8 to 9 ms
    rec.profiler = types.SimpleNamespace(events=lambda: [
        _Ev("fill", 5000, 5001), _Ev("gmm_ragged_tc_kernel", 6000, 8000),
        _Ev("x", 7000, 9000), _Ev("paged_decode_tc", 13000, 14000)])
    red = trace.reduce(types.SimpleNamespace(rec=rec))
    assert red["window_s"] == pytest.approx(0.010)
    assert red["busy_s"] == pytest.approx(0.004)
    assert trace.kernel_seconds(red, "gmm_ragged") == pytest.approx(0.002)
    # gaps: [0, 1 ms) and [4, 8) ms inside the step, [9, 10) after it
    assert red["gaps"]["engine step (decode)"] == pytest.approx(0.005)
    assert sum(red["gaps"].values()) == pytest.approx(0.006)
    bd = trace.breakdown(red)
    assert bd["device_ops"][0][0] in ("gmm_ragged_tc_kernel", "x")
    assert len(bd["idle_gaps"]) == 2
