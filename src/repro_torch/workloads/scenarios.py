"""Declarative scenario registry for the million-request stress harness.

A :class:`Scenario` names one reproducible workload*plane configuration:
a trace generator (a BurstGPT length distribution or a multi-turn
session population), a :class:`LoadShape` retiming the arrivals (ramp,
diurnal sine, Zipf-magnitude bursts — the load patterns fixed-RPS
generation cannot express), and the sim-plane config (SystemConfig +
EngineConfig) it runs against. ``run_scenario`` drives the simulated
cluster at 10^5-10^6 requests with O(1)-memory streaming percentiles
(core/metrics.py) and then asserts the **scenario invariant pack** —
conservation properties over the whole run (every request terminal
exactly once, no duplicates, monotone virtual time, telemetry sums
consistent with the request population, streaming estimates consistent
with exact percentiles) — so a long-horizon sweep doubles as a property
test of the stack under sustained heavy traffic.

Load shaping uses the time-rescaling theorem: arrivals generated at
constant rate are mapped through the inverse normalized cumulative of
the shape's rate profile, so the instantaneous arrival rate tracks the
profile while total count, duration and (local) Poisson structure are
preserved — deterministic per seed.

Real-plane slices: :func:`build_real_slice` emits the same scenario
shape scaled to what a tiny real cluster can serve (short prompts within
its page budget, tokens drawn from the model's vocab), so the sim<->real
differential test and the real-plane dashboard rows run the *same*
registered scenario, smaller.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request, RequestState
from repro_torch.workloads.burstgpt import generate_trace
from repro_torch.workloads.sessions import (SessionConfig, generate_sessions,
                                      session_stats)


# --------------------------------------------------------------------------
# load shapes
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LoadShape:
    """Relative arrival-rate profile f(s) over normalized run time s."""

    kind: str = "constant"       # constant | ramp | diurnal | zipf_burst
    lo: float = 0.4              # ramp: start multiplier
    hi: float = 1.6              # ramp: end multiplier
    amplitude: float = 0.55      # diurnal: sine amplitude (0..1)
    cycles: float = 2.0          # diurnal: full periods over the run
    n_bursts: int = 6            # zipf_burst: burst windows
    burst_x: float = 5.0         # zipf_burst: largest burst multiplier
    burst_frac: float = 0.03     # zipf_burst: each window's width

    def profile(self, s: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.kind == "constant":
            return np.ones_like(s)
        if self.kind == "ramp":
            return self.lo + (self.hi - self.lo) * s
        if self.kind == "diurnal":
            return 1.0 + self.amplitude * np.sin(
                2.0 * np.pi * self.cycles * s)
        if self.kind == "zipf_burst":
            # burst magnitudes fall off Zipf-like with rank; positions are
            # seeded draws, so the burst schedule is reproducible
            f = np.ones_like(s)
            centers = rng.random(self.n_bursts)
            for rank, c in enumerate(centers, start=1):
                mag = self.burst_x / rank ** 0.8
                in_w = np.abs(s - c) <= self.burst_frac / 2.0
                f = np.where(in_w, f + mag, f)
            return f
        raise ValueError(f"unknown load shape {self.kind!r}")


def retime_arrivals(arrivals: np.ndarray, shape: LoadShape,
                    seed: int = 0) -> np.ndarray:
    """Map constant-rate arrivals onto ``shape``'s rate profile
    (time-rescaling: fraction-arrived-by-t follows the normalized
    cumulative profile). Monotone, duration- and count-preserving."""
    if shape.kind == "constant" or arrivals.size == 0:
        return arrivals
    T = float(arrivals[-1])
    if T <= 0:
        return arrivals
    grid = np.linspace(0.0, 1.0, 2049)
    f = np.maximum(shape.profile(grid, np.random.default_rng(seed)), 0.05)
    c = np.concatenate([[0.0], np.cumsum(
        (f[1:] + f[:-1]) * 0.5 * np.diff(grid))])
    c /= c[-1]
    return T * np.interp(arrivals / T, c, grid)


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named workload * load shape * plane configuration."""

    name: str
    description: str = ""
    kind: str = "oneshot"              # oneshot | session
    # ---- one-shot trace (workloads/burstgpt.py)
    dist: str = "random"
    mean_output: float = 48.0
    burstiness: float = 1.0
    # stress scale-down of the BurstGPT prompt lengths: the length *shape*
    # is the scenario's point, the raw magnitudes are testbed-sized
    prompt_scale: float = 0.25
    # ---- session trace (workloads/sessions.py); kind == "session"
    session: Optional[SessionConfig] = None
    # ---- load
    rps: float = 24.0                  # mean request rate (turns/s for
                                       # session scenarios)
    load: LoadShape = LoadShape(kind="constant")
    # ---- sim plane
    system: str = "gimbal"             # PAPER_SYSTEMS key
    n_engines: int = 2
    n_moe_layers: int = 8              # stress-sized MoE dims: the python
    n_experts: int = 32                # event loop, not the (L, E) arrays,
    top_k: int = 4                     # must dominate a 10^5-request run
    window_tokens: int = 200_000
    token_budget: int = 2048
    max_running: int = 256
    kv_tokens: int = 700_000
    kv_block: int = 16
    prefix_sharing: bool = False
    # routing non-stationarity: every this-many routed tokens the hot
    # expert set has fully rotated along the expert axis (0 = stationary;
    # see routing_sim.SourceExpertTraffic)
    routing_shift_tokens: int = 0

    # ---- builders --------------------------------------------------------
    def build(self, n_requests: int, seed: int = 0) -> List[Request]:
        """The scenario's deterministic request trace (sim-plane scale)."""
        if self.kind == "session":
            assert self.session is not None, \
                f"session scenario {self.name} needs a SessionConfig"
            mean_turns = min(self.session.mean_turns, self.session.max_turns)
            reqs = generate_sessions(
                n_requests, self.rps / max(mean_turns, 1.0),
                self.session, seed=seed)
        else:
            reqs = generate_trace(self.dist, n_requests, rps=self.rps,
                                  seed=seed, mean_output=self.mean_output,
                                  burstiness=self.burstiness)
            if self.prompt_scale != 1.0:
                for r in reqs:
                    r.prompt_len = max(int(r.prompt_len
                                           * self.prompt_scale), 16)
        arr = retime_arrivals(
            np.asarray([r.arrival_time for r in reqs]), self.load,
            seed=seed + 101)
        for r, t in zip(reqs, arr):
            r.arrival_time = float(t)
        return reqs

    def system_cfg(self):
        from repro_torch.serving.simulator import PAPER_SYSTEMS
        return dataclasses.replace(
            PAPER_SYSTEMS[self.system], n_engines=self.n_engines,
            n_moe_layers=self.n_moe_layers, n_experts=self.n_experts,
            top_k=self.top_k, window_tokens=self.window_tokens,
            routing_shift_tokens=self.routing_shift_tokens)

    def engine_cfg(self):
        from repro_torch.serving.engine import EngineConfig
        return EngineConfig(token_budget=self.token_budget,
                            max_running=self.max_running,
                            kv_tokens=self.kv_tokens,
                            kv_block=self.kv_block,
                            prefix_sharing=self.prefix_sharing)


SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(s: Scenario) -> Scenario:
    assert s.name not in SCENARIOS, f"duplicate scenario {s.name!r}"
    SCENARIOS[s.name] = s
    return s


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


register_scenario(Scenario(
    name="ramp_random",
    description="BurstGPT random lengths under a 0.4x->1.6x load ramp "
                "(MoEless-style serverless ramp-up)",
    dist="random", rps=22.0,
    load=LoadShape(kind="ramp", lo=0.4, hi=1.6)))

register_scenario(Scenario(
    name="diurnal_two_end",
    description="two-end (short+long bimodal) lengths under a diurnal "
                "sine: overnight trough, daytime peak, two cycles",
    dist="two_end", rps=20.0,
    load=LoadShape(kind="diurnal", amplitude=0.55, cycles=2.0)))

register_scenario(Scenario(
    name="zipf_burst_central",
    description="central lengths, gamma inter-arrivals (CV~1.6) plus "
                "Zipf-magnitude burst windows (BurstGPT burstiness)",
    dist="central", rps=18.0, burstiness=2.5,
    load=LoadShape(kind="zipf_burst", n_bursts=6, burst_x=5.0)))

register_scenario(Scenario(
    name="zipf_shift",
    description="central lengths at steady load while the Zipf hot-expert "
                "set rotates continuously along the expert axis (seeded "
                "routing drift): reactive placement chases the last "
                "window, predictive placement aims at the next one",
    dist="central", rps=20.0, window_tokens=40_000,
    routing_shift_tokens=80_000))

register_scenario(Scenario(
    name="agentic_sessions",
    description="multi-turn agentic sessions: turns re-arrive carrying "
                "the full prior conversation as an exact prompt prefix "
                "(radix cache + affinity stress)",
    kind="session", rps=40.0, prefix_sharing=True,
    session=SessionConfig(mean_turns=4.0, max_turns=10,
                          base_prompt=(48, 160), user_tokens=(8, 40),
                          output_tokens=(16, 48), think_time_s=2.0,
                          vocab=256)))

register_scenario(Scenario(
    name="chat_oneshot",
    description="one-shot counterpart of agentic_sessions: same token "
                "volumes, every prompt independent — the prefix-hit-rate "
                "control",
    kind="session", rps=40.0, prefix_sharing=True,
    session=SessionConfig(mean_turns=1.0, max_turns=1,
                          base_prompt=(150, 320), output_tokens=(16, 48),
                          vocab=256)))


# --------------------------------------------------------------------------
# real-plane slices
# --------------------------------------------------------------------------
def build_real_slice(scenario: Scenario, n_requests: int, *, seed: int = 0,
                     vocab: int, max_prompt: int, rps: float = 3.0,
                     fold_assistant: Optional[bool] = None) -> List[Request]:
    """The same scenario shape at real-tiny-cluster scale: session turns
    keep the true-prefix property; one-shot scenarios become short
    token-bearing prompts with the scenario's length *ordering* and load
    shape. Prompts are bounded by ``max_prompt`` (page-table capacity)
    and drawn from ``[0, vocab)``."""
    if scenario.kind == "session":
        sc = scenario.session
        fold = sc.fold_assistant if fold_assistant is None \
            else fold_assistant
        out_lohi, usr_lohi = (4, 8), (3, 9)
        per_turn = usr_lohi[1] + (out_lohi[1] if fold else 0)
        base_hi = max(min(max_prompt // 3, max_prompt - per_turn), 6)
        # as many turns as the worst-case final prompt leaves room for
        turns = max(1, min(sc.max_turns,
                           1 + (max_prompt - base_hi) // per_turn))
        sc = dataclasses.replace(
            sc, vocab=vocab, think_time_s=1.0, fold_assistant=fold,
            output_tokens=out_lohi, user_tokens=usr_lohi,
            base_prompt=(max(base_hi // 2, 4), base_hi),
            max_turns=turns, mean_turns=min(sc.mean_turns, float(turns)))
        mean_turns = min(sc.mean_turns, sc.max_turns)
        reqs = generate_sessions(n_requests, rps / max(mean_turns, 1.0),
                                 sc, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        base = generate_trace(scenario.dist, n_requests, rps=rps, seed=seed,
                              mean_output=6.0,
                              burstiness=scenario.burstiness)
        lo, hi = 4, max(max_prompt - 10, 8)
        lens = np.asarray([r.prompt_len for r in base], dtype=np.float64)
        lens = lo + (lens - lens.min()) / max(lens.max() - lens.min(), 1.0) \
            * (hi - lo)
        reqs = []
        for i, r in enumerate(base):
            plen = int(lens[i])
            reqs.append(Request(
                req_id=i, prompt_len=plen,
                max_new_tokens=int(min(r.max_new_tokens, 8)),
                arrival_time=r.arrival_time,
                prompt_tokens=[int(x) for x in
                               rng.integers(0, vocab, plen)]))
    arr = retime_arrivals(np.asarray([r.arrival_time for r in reqs]),
                          scenario.load, seed=seed + 101)
    for r, t in zip(reqs, arr):
        r.arrival_time = float(t)
    return reqs


# --------------------------------------------------------------------------
# the invariant pack
# --------------------------------------------------------------------------
def check_scenario_invariants(requests: List[Request], res, engines=None,
                              metrics=None) -> Dict[str, float]:
    """Conservation invariants over a completed scenario run. Raises
    ``AssertionError`` on any violation; returns the checked aggregates
    (they go into the dashboard JSON as proof-of-run)."""
    reqs = sorted(requests, key=lambda r: r.req_id)
    ids = [r.req_id for r in reqs]
    assert len(set(ids)) == len(ids), "duplicate req_ids in trace"
    arr = np.asarray([r.arrival_time for r in reqs])
    assert arr.size == 0 or (np.diff(arr) >= 0).all() and arr[0] >= 0.0, \
        "arrivals not monotone in req_id order"

    # ---- every request terminal, exactly once, fully served
    for r in reqs:
        assert r.state is RequestState.FINISHED, \
            f"request {r.req_id} not terminal: {r.state}"
        assert not r.error, f"request {r.req_id} errored: {r.error}"
        assert r.generated == r.max_new_tokens, \
            f"request {r.req_id} under-generated: " \
            f"{r.generated}/{r.max_new_tokens}"
        # monotone per-request virtual time
        assert r.arrival_time <= r.dispatch_time + 1e-9, \
            f"request {r.req_id} dispatched before arrival"
        assert r.dispatch_time <= r.first_token_time + 1e-9 \
            and r.first_token_time <= r.finish_time + 1e-9, \
            f"request {r.req_id} time-travels: " \
            f"{r.dispatch_time} -> {r.first_token_time} -> {r.finish_time}"
    max_finish = max((r.finish_time for r in reqs), default=0.0)
    assert max_finish <= res.duration_s + 1e-6, \
        f"finish time {max_finish} past run duration {res.duration_s}"

    out = {"n_requests": len(reqs), "max_finish_s": max_finish}
    preempts = sum(r.n_preemptions for r in reqs)
    out["preemptions"] = preempts

    # ---- per-engine partition + telemetry conservation
    if engines is not None:
        fin_ids: List[int] = []
        for e in engines:
            times = [r.finish_time for r in e.finished]
            assert all(t2 >= t1 - 1e-9 for t1, t2
                       in zip(times, times[1:])), \
                f"engine {e.engine_id} finish times not monotone"
            fin_ids.extend(r.req_id for r in e.finished)
            pool = getattr(e, "pool", None)
            if pool is not None:
                if hasattr(pool, "check_invariants"):
                    pool.check_invariants()
                assert pool.usage == 0.0, \
                    f"engine {e.engine_id} pool not drained: {pool.usage}"
        assert sorted(fin_ids) == sorted(ids), \
            "engines' finished lists do not partition the trace " \
            f"({len(fin_ids)} finishes vs {len(ids)} requests)"

        prefill = sum(e.total_prefill_tokens for e in engines)
        decode = sum(e.total_decode_tokens for e in engines)
        hits = sum(e.prefix_hit_tokens for e in engines)
        prompt_total = sum(r.prompt_len for r in reqs)
        decode_expected = sum(r.max_new_tokens - 1 for r in reqs)
        recoveries = sum(r.n_recoveries for r in reqs)
        if preempts == 0 and recoveries == 0:
            assert prefill + hits == prompt_total, \
                f"prefill conservation broken: {prefill} executed + " \
                f"{hits} cache-skipped != {prompt_total} prompt tokens"
            assert decode == decode_expected, \
                f"decode conservation broken: {decode} != {decode_expected}"
        else:   # recomputed work only ever adds tokens
            assert prefill + hits >= prompt_total, \
                f"prefill under-counted: {prefill}+{hits} < {prompt_total}"
            assert decode >= decode_expected, \
                f"decode under-counted: {decode} < {decode_expected}"
        out.update(prefill_tokens=prefill, decode_tokens=decode,
                   prefix_hit_tokens=hits, prompt_tokens=prompt_total,
                   hit_rate=hits / max(prompt_total, 1))

    # ---- streaming estimates consistent with the exact percentiles
    if metrics is not None:
        ok = [r for r in reqs if not r.error]
        ttft = np.asarray([r.ttft for r in ok])
        snap = metrics.snapshot()["metrics"]
        assert snap["ttft"]["count"] == len(ok), \
            f"metrics saw {snap['ttft']['count']} finishes, " \
            f"trace has {len(ok)}"
        exact_mean = float(ttft.mean())
        assert abs(snap["ttft"]["mean"] - exact_mean) \
            <= 1e-6 * max(abs(exact_mean), 1.0), "streaming mean diverged"
        rank_tol = max(0.02, 3.0 / np.sqrt(max(len(ok), 1)))
        for q in (0.5, 0.99):
            est = metrics.quantile("ttft", q)
            rank = float((ttft <= est).mean())
            assert abs(rank - q) <= rank_tol + (1.0 - q), \
                f"p{q * 100:g} TTFT estimate {est} sits at rank {rank}"
            merged = metrics.merged_window_quantile("ttft", q)
            mrank = float((ttft <= merged).mean())
            assert abs(mrank - q) <= rank_tol + (1.0 - q), \
                f"merged-window p{q * 100:g} {merged} sits at rank {mrank}"
        out["metrics_count"] = snap["ttft"]["count"]
    return out


# --------------------------------------------------------------------------
# the sim-plane runner
# --------------------------------------------------------------------------
def run_scenario(scenario: Scenario, n_requests: int, *, seed: int = 0,
                 series: bool = False, check: bool = True,
                 window_s: Optional[float] = None) -> Tuple[Dict, object]:
    """Build + serve + verify one scenario on the simulated plane.

    Returns ``(dashboard, SimResult)``: the dashboard dict is the
    per-scenario record ``BENCH_scenarios.json`` stores (percentiles,
    scheduler/cache/swap telemetry, invariant aggregates)."""
    from repro_torch.core.metrics import StreamingMetrics
    from repro_torch.serving.simulator import simulate

    t0 = time.perf_counter()
    reqs = scenario.build(n_requests, seed=seed)
    build_s = time.perf_counter() - t0
    span = reqs[-1].arrival_time if reqs else 0.0
    metrics = StreamingMetrics(
        window_s=window_s or max(span / 64.0, 1.0), seed=seed)
    t0 = time.perf_counter()
    res = simulate(reqs, scenario.system_cfg(),
                   engine_cfg=scenario.engine_cfg(), traffic_seed=seed,
                   horizon_s=span + 36_000.0, metrics=metrics)
    wall = time.perf_counter() - t0
    inv = check_scenario_invariants(
        reqs, res, engines=res.engines, metrics=metrics) if check else {}
    snap = metrics.snapshot(series=series)
    dash = {
        "scenario": scenario.name,
        "description": scenario.description,
        "kind": scenario.kind,
        "plane": "sim",
        "n_requests": len(reqs),
        "seed": seed,
        "duration_s": res.duration_s,
        "wall_s": wall,
        "build_s": build_s,
        "requests_per_wall_s": len(reqs) / max(wall, 1e-9),
        "throughput_rps": res.throughput,
        "latency": snap["metrics"],
        "scheduler": {
            "decisions": {k: int(v) for k, v in
                          res.signals.get("decisions", {}).items()},
            "preemptions": res.signals.get("preemptions", 0),
            "prefill_dispatches": res.signals.get("prefill_dispatches", 0),
            "prefill_lanes_per_dispatch": res.signals.get(
                "prefill_lanes_per_dispatch", 0.0),
            "avg_running": res.signals.get("avg_running", 0.0),
        },
        "cache": {
            "prefix_hit_tokens": inv.get("prefix_hit_tokens", 0),
            "hit_rate": inv.get("hit_rate", 0.0),
            "kv_usage_mean": res.signals.get("kv_usage", 0.0),
        },
        "swap": {
            "swapped_tokens": res.signals.get("swapped_tokens", 0),
            "preempt_recompute": inv.get("preemptions", 0),
        },
        "invariants": {k: float(v) for k, v in inv.items()},
        "invariants_ok": bool(check),
    }
    if scenario.kind == "session":
        dash["sessions"] = session_stats(reqs)
    if series:
        dash["series"] = snap.get("series", {})
    return dash, res
