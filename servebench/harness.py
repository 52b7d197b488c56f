"""One run of one cell: set-up, the measured window, and what it recorded.

The window drives the port's ``serve_real_cluster`` over two
``PagedRealEngine``s that share one ``PagedModelRunner``, as a user drives
it, with the Gimbal scheduler, MoE-pressure feedback and the calibrated
placement at their defaults. Nothing of the program is edited: the
benchmark wraps each engine instance's ``step``, ``enqueue`` and
``window_stats`` to read the host clock around the step (every step ends in
a host sync), which requests gained tokens, and the statistics handed to
the coordinator. It ends the serve at the first round boundary after
``--seconds`` by raising from the wrapper; ``serve_real_cluster``'s
``finally`` puts the experts back.

Arrivals are on the cluster's round clock (``RealClusterConfig.dt``): the
load is fixed per round, and a faster program serves more rounds in the
window. A request is due at the wall time at which the round that
dispatches it begins (the first wrapped call of that round).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from servebench import arch, costs, gen_traffic
from servebench import weights as W

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


def log(msg: str, t_start: float) -> None:
    """A progress line on standard error, with the seconds since start."""
    sys.stderr.write(f"servebench {time.perf_counter() - t_start:8.2f}s "
                     f"{msg}\n")
    sys.stderr.flush()


def cpu_model() -> str:
    """The host's CPU as ``/proc/cpuinfo`` names its first processor: the
    model name, and the vendor, family and model numbers (a sandbox may
    name the model "unknown" and still give the numbers)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    return (f"{fields.get('model name', 'unknown')} "
            f"({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')})")


def host_line(cpu: str) -> str:
    """The host as a run finds it: the CPU, the logical CPUs (and those
    this process may use) and the load average over 1, 5 and 15 minutes.
    No metric: it helps explain a host-paced spread."""
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return (f"host {cpu}; {os.cpu_count()} logical CPUs, "
            f"{len(os.sched_getaffinity(0))} usable; load average {load}")


class WindowClosed(Exception):
    """Raised from a wrapped engine call at the round that closes the
    window: ends the serve."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged (but a
    check's ``limits``, which are replaced whole)."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and k != "limits" \
            and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file as run
    traffic: dict         # the traffic mix's parameters
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int
    arch: arch.Arch       # the adapter of the configuration's model_type


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, size: str = "full",
              spec_path: Path = ROOT / "BENCHMARK.json",
              arch_dirs: Sequence = ()) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration (a path
    relative to the spec's directory) and traffic files found by name, and
    the architecture adapter of the configuration's ``model_type``.
    ``size="smoke"`` applies each file's ``smoke`` section: the CPU-sized
    model and traffic of the tests. ``arch_dirs``: more directories of
    adapters, for tests."""
    spec = load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path.name}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = load_json(spec_path.parent / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    if size == "smoke":
        cfg = merged(cfg, cfg["smoke"])
        traffic = merged(traffic, traffic["smoke"])
    return Cell(name=name, config=cfg, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
                chips=int(w["chips"]),
                arch=arch.find(cfg["model_type"], arch_dirs))


# ---------------------------------------------------------------- program
def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def program_params(adapter: arch.Arch, cfg: dict, mcfg, seed: int, device):
    """The benchmark's weights in the port's tree: the leaf layout from
    the port's own ``init_params`` on the ``meta`` device (shapes and
    types only, nothing drawn), every value from :mod:`weights` under the
    checkpoint leaf and layer that the adapter maps to it
    (``checkpoint_leaves``). A leaf the adapter does not map, or does not
    cover, is refused."""
    from repro_torch.models import transformer as tfm
    meta = tfm.init_params(mcfg, generator=torch.Generator(), device="meta")
    period = len(meta.get("blocks", {}))
    tree: Dict = {}
    for path, leaf in _flat(meta):
        shape = tuple(leaf.shape)
        try:
            slots = adapter.program.checkpoint_leaves(path, shape, period)
        except KeyError:
            raise ValueError(f"{mcfg.name}: the adapter {adapter.name} "
                             f"maps no checkpoint leaf to the port's "
                             f"{path}") from None
        index = [s.index for s in slots]
        if index != [None] and (None in index or sorted(index) != list(
                range(shape[0] if shape else 0))):
            raise ValueError(f"{mcfg.name}: the adapter {adapter.name} "
                             f"does not cover the port's {path} {shape}")
        out = torch.empty(shape, dtype=leaf.dtype, device=device)
        for s in slots:
            dst = out if s.index is None else out[s.index]
            x = W.draw(seed, s.name, s.layer,
                       adapter.ref.leaves(cfg, s.layer)[s.name], device)
            if s.transform is not None:
                x = s.transform(x)
            if x.shape != dst.shape:
                raise ValueError(f"{s.name}: the port holds "
                                 f"{tuple(dst.shape)}, the checkpoint "
                                 f"{tuple(x.shape)}")
            dst.copy_(x)
            del x
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = out
    return tree


def engine_config(cfg: dict, device: str):
    """The port's ``PagedEngineConfig`` from the configuration's ``engine``
    section: ``kv_tokens_per_engine`` sizes the pool, ``engines`` is the
    cluster's; every other key is a field of the config (lists become
    tuples)."""
    from repro_torch.serving.paged_engine import PagedEngineConfig
    e = dict(cfg["engine"])
    e.pop("engines")
    n_pages = e.pop("kv_tokens_per_engine") // e["page_size"]
    e = {k: tuple(v) if isinstance(v, list) else v for k, v in e.items()}
    return PagedEngineConfig(n_pages=n_pages, device=device, **e)


def make_engines(cfg: dict, mcfg, runner):
    from repro_torch.serving.paged_engine import PagedRealEngine
    return [PagedRealEngine(i, mcfg, runner.params, runner.ecfg,
                            runner=runner, n_sources=cfg["engine"]["engines"])
            for i in range(cfg["engine"]["engines"])]


def cluster_config(cfg: dict):
    """The port's ``RealClusterConfig``: one rank an engine, and the
    configuration's ``cluster`` section (none: the defaults, Gimbal with
    MoE feedback and the calibrated placement)."""
    from repro_torch.serving.real_cluster import RealClusterConfig
    return RealClusterConfig(n_ranks=cfg["engine"]["engines"],
                             max_rounds=10 ** 9, **cfg.get("cluster", {}))


def program_requests(reqs: List[gen_traffic.TrafficRequest], dt: float):
    """The program's requests: each due in round ``ceil(arrival_round)``,
    its arrival half a round before that round's clock so that the
    cluster's summed clock cannot shift it by a round."""
    from repro_torch.serving.request import Request
    out = []
    for r in reqs:
        due = max(0, math.ceil(r.arrival_round - 1e-9))
        out.append(Request(req_id=r.req_id, prompt_len=len(r.prompt),
                           max_new_tokens=r.max_new_tokens,
                           arrival_time=(due - 0.5) * dt if due else 0.0,
                           prompt_tokens=r.prompt))
    return out


# ---------------------------------------------------------------- recorder
@dataclasses.dataclass
class ReqRecord:
    due_round: int
    prompt_len: int
    due_wall: Optional[float] = None
    first_wall: Optional[float] = None     # end of the step of token 1
    first_round: Optional[int] = None
    seen: int = 0                          # most tokens ever emitted
    window_tokens: List[float] = dataclasses.field(default_factory=list)
    finish_wall: Optional[float] = None
    error: Optional[str] = None


@dataclasses.dataclass
class StepRecord:
    round: int
    engine: int
    t0: float
    t1: float
    worked: bool
    prefill_tokens: int = 0
    prefill_ctx: int = 0
    decode_tokens: int = 0
    decode_ctx: int = 0
    decode_blocks: int = 0
    logits: int = 0
    new_tokens: int = 0
    expert_counts: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def kind(self) -> str:
        p, d = self.prefill_tokens > 0, self.decode_tokens > 0
        return {(True, True): "prefill and decode", (True, False): "prefill",
                (False, True): "decode"}.get((p, d), "no work")


class Recorder:
    """Wraps the engines' calls and keeps the run's host-clock stamps.

    Round ``r`` begins at the first wrapped call whose ``now`` is round
    ``r``'s. The window opens at round ``open_round``, and closes at the
    first round that begins ``seconds`` or more after it opened. In a
    traced run the profiler covers rounds [``trace_from``, ``trace_to``)."""

    def __init__(self, engines, dt: float, open_round: int, seconds: float,
                 page_size: int, trace_rounds=None, on_open=None,
                 rounds: Optional[int] = None, clock=time.perf_counter):
        self.engines, self.dt = engines, dt
        self.open_round, self.seconds = open_round, seconds
        self.rounds = rounds                  # close by rounds (the sweep)
        self.page_size = page_size
        self.clock = clock
        self.on_open = on_open
        self.round = -1
        self.round_start: Dict[int, float] = {}
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.close_round: Optional[int] = None
        self.steps: List[StepRecord] = []
        self.reqs: Dict[int, ReqRecord] = {}
        self.stats_fed: List[tuple] = []      # (round, engine, B, A)
        # every prefill dispatch: its lanes (req_id, start, chunk) and the
        # per-layer expert counts B it logged
        self.prefill_dispatches: List[tuple] = []
        # the most pages each engine's pool held at a round's start
        self.kv_pages_peak: Dict[int, int] = {}
        self.counters_open: Dict[int, tuple] = {}
        self.counters_close: Dict[int, tuple] = {}
        self.trace_rounds = trace_rounds      # (from, to) or None
        self.profiler = None
        self.trace_mark: Optional[float] = None
        self.trace_end: Optional[float] = None
        for e in engines:
            self._wrap(e)

    # ---- round boundaries ------------------------------------------------
    def _round_of(self, now: float) -> int:
        return int(round(now / self.dt))

    def _counters(self):
        return {e.engine_id: (e.step_count, e.total_prefill_tokens,
                              e.total_decode_tokens) for e in self.engines}

    def _begin(self, now: float) -> None:
        r = self._round_of(now)
        if r <= self.round:
            return
        t = self.clock()
        self.round = r
        self.round_start[r] = t
        for e in self.engines:
            used = e.pool.total_blocks - e.pool.free_blocks
            self.kv_pages_peak[e.engine_id] = max(
                used, self.kv_pages_peak.get(e.engine_id, 0))
        if self.trace_rounds is not None:
            if r == self.trace_rounds[0] and self.t_open is not None:
                self._trace_start()
            elif r == self.trace_rounds[1]:
                self._trace_stop()
        if r == self.open_round:
            self.t_open = t
            self.counters_open = self._counters()
            if self.on_open is not None:
                self.on_open()
        elif self.t_open is not None and (
                t - self.t_open >= self.seconds if self.rounds is None
                else r >= self.open_round + self.rounds):
            self.t_close, self.close_round = t, r
            self.counters_close = self._counters()
            self._trace_stop()
            raise WindowClosed()

    def in_window(self, r: int) -> bool:
        return self.t_open is not None and r >= self.open_round and (
            self.close_round is None or r < self.close_round)

    # ---- tracing ---------------------------------------------------------
    def _trace_start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        dev = self.engines[0].runner.device
        self.profiler = profile(activities=[ProfilerActivity.CUDA])
        self.profiler.start()
        torch.cuda.synchronize(dev)
        # the first device event of the trace: it aligns the trace's clock
        # with the host's (the device is idle at a round boundary)
        self.trace_mark = self.clock()
        torch.empty(1, device=dev).fill_(1.0)
        torch.cuda.synchronize(dev)

    def _trace_stop(self) -> None:
        if self.profiler is None or self.trace_end is not None:
            return
        torch.cuda.synchronize(self.engines[0].runner.device)
        self.trace_end = self.clock()
        self.profiler.stop()

    # ---- the wrappers ----------------------------------------------------
    def _wrap(self, e) -> None:
        step, enqueue, window_stats = e.step, e.enqueue, e.window_stats
        run_prefill = e._run_prefill_group
        rec = self

        def wrapped_enqueue(req, now):
            rec._begin(now)
            return enqueue(req, now)

        def wrapped_step(now):
            rec._begin(now)
            r = rec.round
            before = {q.req_id: (q, q.prefill_done, q.generated)
                      for q in e.running + e.waiting}
            n_log = len(e.stats_log)
            steps_before = e.step_count
            t0 = rec.clock()
            finished = step(now)
            t1 = rec.clock()
            rec._after_step(e, r, t0, t1, before, finished,
                            e.step_count > steps_before, n_log)
            return finished

        def wrapped_window_stats():
            B, A = window_stats()
            if B is not None and rec.in_window(rec.round):
                rec.stats_fed.append((rec.round, e.engine_id, B, A))
            return B, A

        def wrapped_prefill(group, now):
            n_log = len(e.stats_log)
            finished = run_prefill(group, now)
            if len(e.stats_log) > n_log:
                rec.prefill_dispatches.append((
                    [(l.req.req_id, l.start, l.chunk) for l in group],
                    e.stats_log[n_log]["expert_counts"]))
            return finished

        e.enqueue, e.step, e.window_stats = (wrapped_enqueue, wrapped_step,
                                             wrapped_window_stats)
        e._run_prefill_group = wrapped_prefill

    def _after_step(self, e, r, t0, t1, before, finished, worked, n_log):
        s = StepRecord(round=r, engine=e.engine_id, t0=t0, t1=t1,
                       worked=worked,
                       expert_counts=[d["expert_counts"]
                                      for d in e.stats_log[n_log:]])
        window = self.in_window(r)
        ps = self.page_size
        for rid, (q, pd, g) in before.items():
            rr = self.reqs.get(rid)
            if rr is None:
                continue
            if q.prefill_done > pd:
                n = q.prefill_done - pd
                s.prefill_tokens += n
                s.prefill_ctx += costs.ctx_sum(pd, n)
                if q.generated > 0 and g == 0:
                    s.logits += 1
            elif q.generated > g and g > 0:
                ctx = q.prompt_len + g
                s.decode_tokens += 1
                s.decode_ctx += ctx
                s.decode_blocks += -(-ctx // ps)
                s.logits += 1
            new = q.generated - rr.seen
            if new > 0:
                rr.seen = q.generated
                s.new_tokens += new
                if rr.first_wall is None:
                    rr.first_wall, rr.first_round = t1, r
                if window:
                    rr.window_tokens.extend([t1] * new)
        for q in finished:
            rr = self.reqs.get(q.req_id)
            if rr is not None:
                rr.finish_wall = t1
                rr.error = q.error
        self.steps.append(s)

    def backlog(self, r: int) -> int:
        """Requests due by round ``r`` and still without a first token as
        it began."""
        return sum(1 for q in self.reqs.values() if q.due_round <= r and (
            q.first_round is None or q.first_round >= r))

    def set_due(self) -> None:
        for rr in self.reqs.values():
            if rr.due_wall is None and rr.due_round in self.round_start:
                rr.due_wall = self.round_start[rr.due_round]


# ---------------------------------------------------------------- the run
@dataclasses.dataclass
class Run:
    """What one run recorded, for the metric readers."""
    cell: Cell
    seed: int
    device: str
    rec: Recorder
    setup_s: float
    served: Dict[int, dict]        # req_id -> prompt, output, finished in win
    trace: Optional[dict] = None   # reduced profile of the traced stretch
    trace_excluded: tuple = ()     # rounds the traced stretch perturbed

    @property
    def window_s(self) -> float:
        return self.rec.t_close - self.rec.t_open

    def window_rounds(self) -> List[int]:
        return [r for r in range(self.rec.open_round, self.rec.close_round)
                if r not in self.trace_excluded]

    def due_requests(self) -> List[ReqRecord]:
        return [rr for rr in self.rec.reqs.values()
                if self.rec.open_round <= rr.due_round < self.rec.close_round]

    def window_steps(self, untraced: bool = False) -> List[StepRecord]:
        return [s for s in self.rec.steps if self.rec.in_window(s.round)
                and not (untraced and s.round in self.trace_excluded)]


def _warmup_requests(traffic: dict, vocab: int, seed: int):
    """Short requests that touch the cell's (B, S) buckets: all due at
    round 0, three tokens each."""
    lens = traffic["warmup_prompts"]
    rng = np.random.default_rng(gen_traffic._seed_seq(seed, 9))
    return [gen_traffic.TrafficRequest(
        req_id=10 ** 9 + i, prompt=rng.integers(0, vocab, n).astype(np.int32),
        max_new_tokens=3, arrival_round=0.0)
        for i, n in enumerate(lens)]


@dataclasses.dataclass
class Program:
    """The program as set up for a cell: the model config, the runner with
    the benchmark's weights, and the cluster config."""
    mcfg: object
    runner: object
    ccfg: object


def setup_program(cell: Cell, seed: int, device: str,
                  t_start: float) -> Program:
    """Build the kernels (cached in the checkout), make the weights from
    the seed, and warm up with one short serve over every bucket the
    cell's traffic uses, then discard it."""
    from repro_torch.kernels import ops
    from repro_torch.serving.paged_engine import PagedModelRunner
    from repro_torch.serving.real_cluster import serve_real_cluster
    cfg = cell.config
    if device == "cuda":
        log(f"built the kernels in {ops.build():.2f}s", t_start)
        torch.cuda.reset_peak_memory_stats()
    mcfg = cell.arch.program.model_config(cfg)
    params = program_params(cell.arch, cfg, mcfg, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    log("weights made", t_start)
    runner = PagedModelRunner(mcfg, params, engine_config(cfg, device),
                              n_sources=cfg["engine"]["engines"])
    prog = Program(mcfg=mcfg, runner=runner, ccfg=cluster_config(cfg))
    engines = make_engines(cfg, mcfg, runner)
    serve_real_cluster(program_requests(
        _warmup_requests(cell.traffic, cfg["vocab_size"], seed),
        prog.ccfg.dt), engines, cluster_cfg=prog.ccfg)
    del engines
    gc.collect()
    log("warm-up served", t_start)
    return prog


def serve(cell: Cell, prog: Program, seed: int, seconds: float,
          trace: bool, t_start: float, rounds: Optional[int] = None) -> Run:
    """The measured serve: the ramp, then the window of ``seconds`` (or of
    ``rounds`` rounds). Returns the run's record; the engines and their
    pages are freed."""
    from repro_torch.serving.real_cluster import serve_real_cluster
    cfg, traffic = cell.config, cell.traffic
    dt = prog.ccfg.dt
    ramp = int(traffic["ramp_rounds"])
    horizon = ramp + int(traffic["horizon_rounds"])
    treqs = gen_traffic.generate(
        traffic, seed, cfg["vocab_size"],
        gen_traffic.requests_for_rounds(traffic, horizon))
    reqs = program_requests(treqs, dt)
    engines = make_engines(cfg, prog.mcfg, prog.runner)
    log(f"{len(reqs)} requests generated, engines made", t_start)
    trace_rounds = None
    if trace:
        a = ramp + int(traffic["trace"]["offset_rounds"])
        trace_rounds = (a, a + int(traffic["trace"]["rounds"]))
    setup = {}
    rec = Recorder(engines, dt, ramp, seconds,
                   prog.runner.ecfg.page_size, trace_rounds=trace_rounds,
                   on_open=lambda: setup.setdefault(
                       "s", time.perf_counter() - t_start), rounds=rounds)
    for t, q in zip(treqs, reqs):
        rec.reqs[q.req_id] = ReqRecord(
            due_round=max(0, math.ceil(t.arrival_round - 1e-9)),
            prompt_len=q.prompt_len)
    cpu = cpu_model()
    # the host before the ramp, and again after the window has closed
    log("ramp begins: " + host_line(cpu), t_start)
    try:
        serve_real_cluster(reqs, engines, cluster_cfg=prog.ccfg)
    except WindowClosed:
        log("window closed: " + host_line(cpu), t_start)
    else:
        raise RuntimeError("the serve ended before the window closed: "
                           "raise horizon_rounds")
    finally:
        rec._trace_stop()
    rec.set_due()
    n = rec.close_round - rec.open_round
    pages = prog.runner.ecfg.n_pages
    log(f"window closed: rounds {rec.open_round}..{rec.close_round}, "
        f"{(rec.t_close - rec.t_open) / max(n, 1):.4f}s a round, ramp and "
        f"set-up {setup['s']:.2f}s; backlog {rec.backlog(rec.open_round)} "
        f"-> {rec.backlog(rec.close_round - 1)}; KV pages at most "
        + ", ".join(f"{v} of {pages}" for _, v in
                    sorted(rec.kv_pages_peak.items()))
        + "; round walls (ms) "
        + " ".join(str(round(1e3 * (rec.round_start[r + 1]
                                    - rec.round_start[r])))
                   for r in range(rec.open_round, rec.close_round)), t_start)
    served = {}
    for q in reqs:
        rr = rec.reqs[q.req_id]
        if rr.finish_wall is not None and rec.t_open <= rr.finish_wall \
                <= rec.t_close and not q.error:
            served[q.req_id] = {"req_id": q.req_id,
                                "prompt": np.asarray(q.prompt_tokens),
                                "output": list(q.output_tokens)}
    run = Run(cell=cell, seed=seed, device=str(prog.runner.device), rec=rec,
              setup_s=setup["s"], served=served)
    if trace_rounds is not None:
        a, b = trace_rounds
        # the stretch's rounds and the one its stop fell in
        run.trace_excluded = tuple(range(a, b + 1))
    rec.engines = []
    del engines, reqs
    gc.collect()
    return run


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float,
             rounds: Optional[int] = None) -> Run:
    """Set-up, the window (of ``seconds``, or of ``rounds`` rounds where
    given: the CPU tests, whose host's speed varies), and the program's
    outputs; the program's state is freed before this returns."""
    prog = setup_program(cell, seed, device, t_start)
    run = serve(cell, prog, seed, seconds, trace, t_start, rounds)
    del prog
    gc.collect()
    return run
