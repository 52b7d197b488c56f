"""Fine-grained DP-engine scheduling (paper §4, Algorithm 1).

Pressure-aware admission control: KV-protection fast path, score-based
selection with compensation for dispatches made since the last trace refresh,
and a CLOSE guard that falls back to ordered dispatch when scores are within
noise (prevents oscillation on trace jitter).

score_i = (pre_rem_i - affinity_i) + wait_i + comp_i + P_kv(kv_i) + P_moe(moe_i)

``affinity_i`` is the prefix-affinity credit: estimated cache-hit tokens
for this request on engine i, read off the radix prefix summary each
engine ships on its trace. It reduces pre_rem_i (a hit engine prefills
fewer tokens), never overrides the HighKV protection path (which runs
first), and inside the CLOSE band only replaces the arbitrary round-robin
tiebreak — it cannot create or suppress a CLOSE verdict, so the
anti-oscillation property is preserved. Compensation is affinity-aware on
the same estimate: a dispatch expected to hit the cache charges only its
expected *cold* prefill tokens, so back-to-back same-prefix bursts don't
over-penalize the cache-holding engine.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.core.traces import EngineTrace, TraceTable


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    # KV protection (paper §6: HighKV at 90% usage, LargeGap at 10% spread)
    high_kv: float = 0.90
    large_gap: float = 0.10
    # penalty shaping: token-equivalent pressure per unit of kv/moe signal
    kv_penalty_scale: float = 2000.0     # tokens-equivalent at kv_usage = 1.0
    kv_penalty_knee: float = 0.5         # quadratic growth past the knee
    moe_penalty_scale: float = 1.0       # moe_pressure is token-equivalent
    # CLOSE guard: relative score band treated as "equal" (ordered dispatch)
    close_rel: float = 0.02
    close_abs: float = 32.0              # tokens
    # compensation: how much pressure one dispatched request adds until the
    # next trace arrives (its own prefill tokens + fixed decode allowance)
    comp_decode_allowance: float = 64.0
    comp_decay_s: float = 2.0            # compensation half-life (safety)
    # affinity-aware compensation: a request dispatched onto the engine
    # holding its prefix will prefill fewer tokens than prompt_len, so the
    # expected hit is subtracted from its compensation — back-to-back
    # same-prefix bursts then don't over-penalize the cache holder and
    # scatter a family across cold engines. Off -> full-prompt charge.
    affinity_compensation: bool = True
    # prefix-affinity credit: estimated cache-hit tokens (read off the
    # engines' radix prefix summaries) reduce that engine's pending-work
    # score — routing a request to the engine already holding its prefix
    # is backend-state-aware dispatch, the paper's coordination thesis
    # applied to the KV cache. 0.0 disables the signal entirely and
    # bit-reproduces affinity-free dispatch.
    affinity_weight: float = 1.0
    # tiered-KV pressure: tokens parked in the host tier (swapped_tokens,
    # see serving/kv_tier.py) are future swap-in debt the engine must pay
    # before those requests run again. Scaled into the score as a soft
    # penalty; 0.0 (default) ignores the signal and bit-reproduces
    # tier-free dispatch decisions.
    swap_pressure_scale: float = 0.0


class GimbalScheduler:
    """Algorithm 1 (global DP engine scheduling)."""

    def __init__(self, trace_table: TraceTable,
                 config: Optional[SchedulerConfig] = None):
        self.traces = trace_table
        self.cfg = config or SchedulerConfig()
        self._rr = itertools.count()
        self._comp: Dict[int, float] = {}
        self._comp_time: Dict[int, float] = {}
        self._excluded: set = set()
        # per-decision telemetry for the benchmarks/ablation
        self.decisions = {"fallback": 0, "kv_path": 0, "score_path": 0,
                          "close_path": 0, "affinity_path": 0}

    # ---- engine set management (elastic scaling / health) ------------
    def exclude(self, engine_id: int) -> None:
        self._excluded.add(engine_id)

    def include(self, engine_id: int) -> None:
        self._excluded.discard(engine_id)
        # a re-included engine's prefix-summary delta chain is not
        # trustworthy (its cache mutated while we ignored its traces, and
        # an engine restart resets the version counter): demand a full
        # digest on its next trace before crediting affinity again
        if hasattr(self.traces, "request_resync"):
            self.traces.request_resync(engine_id)

    def _engines(self) -> List[int]:
        return [e for e in self.traces.engine_ids if e not in self._excluded]

    def healthy_engines(self) -> List[int]:
        """Engines currently eligible for dispatch (cluster-loop view for
        admission hold/shed decisions)."""
        return self._engines()

    # ---- compensation -------------------------------------------------
    def _compensation(self, engine_id: int, now: float) -> float:
        c = self._comp.get(engine_id, 0.0)
        if c <= 0.0:
            return 0.0
        dt = max(now - self._comp_time.get(engine_id, now), 0.0)
        decay = 0.5 ** (dt / self.cfg.comp_decay_s)
        return c * decay

    def _add_compensation(self, engine_id: int, tokens: float,
                          now: float) -> None:
        self._comp[engine_id] = (self._compensation(engine_id, now)
                                 + tokens + self.cfg.comp_decode_allowance)
        self._comp_time[engine_id] = now

    def on_trace_refresh(self, engine_id: int) -> None:
        """A fresh trace subsumes compensation for that engine."""
        self._comp[engine_id] = 0.0

    # ---- penalties -----------------------------------------------------
    def _p_kv(self, kv: float) -> float:
        c = self.cfg
        over = max(kv - c.kv_penalty_knee, 0.0)
        return c.kv_penalty_scale * (kv + 4.0 * over * over)

    def _p_moe(self, moe: float) -> float:
        return self.cfg.moe_penalty_scale * moe

    def score(self, t: EngineTrace, now: float,
              affinity_credit: float = 0.0) -> float:
        """Pressure score; ``affinity_credit`` (estimated cache-hit tokens,
        pre-weighted) reduces the remaining-prefill term — a request whose
        prefix the engine already holds costs that engine fewer tokens."""
        return (t.remaining_prefill_tokens - affinity_credit
                + t.waiting_prefill_tokens
                + self._compensation(t.engine_id, now)
                + self._p_kv(t.kv_usage) + self._p_moe(t.moe_pressure)
                + self.cfg.swap_pressure_scale * t.swapped_tokens)

    def _affinity_estimates(self, traces: Dict[int, EngineTrace],
                            prompt_tokens) -> Optional[Dict[int, float]]:
        """Raw per-engine cache-hit token estimates for this request, or
        None when the signal is off / absent (no prompt ids, weight 0, no
        engine advertises a prefix summary, or no summary matches). Capped
        at prompt_len - 1: the last prompt token is always recomputed.
        Callers scale by ``affinity_weight`` for the score credit; the
        compensation path uses the raw tokens (expected skipped prefill
        is a physical quantity, not a tunable preference)."""
        if prompt_tokens is None or len(prompt_tokens) <= 1 \
                or self.cfg.affinity_weight <= 0.0:
            return None
        cap = float(len(prompt_tokens) - 1)
        est = {}
        for e, t in traces.items():
            s = t.prefix_summary
            hit = s.estimate_hit_tokens(prompt_tokens) if s is not None else 0
            est[e] = min(float(hit), cap)
        return est if any(v > 0.0 for v in est.values()) else None

    def _charge_dispatch(self, chosen: int, prefill_tokens: float,
                         estimates: Optional[Dict[int, float]],
                         now: float) -> int:
        """Record the dispatch in the compensation books, minus the
        expected prefix hit on the chosen engine (affinity-aware
        compensation). Returns ``chosen`` so call sites stay one line."""
        tokens = prefill_tokens
        if estimates is not None and self.cfg.affinity_compensation:
            tokens = max(prefill_tokens - estimates.get(chosen, 0.0), 0.0)
        self._add_compensation(chosen, tokens, now)
        return chosen

    # ---- Algorithm 1 ----------------------------------------------------
    def _ordered_next(self, engines: List[int]) -> int:
        return engines[next(self._rr) % len(engines)]

    def select_engine(self, prefill_tokens: float, now: float = 0.0,
                      prompt_tokens=None) -> Optional[int]:
        """Pick the engine for a request. ``prompt_tokens`` (optional)
        enables the prefix-affinity credit; omitting it — or zeroing
        ``affinity_weight`` — reproduces affinity-free dispatch decision
        for decision, including round-robin state consumption.

        Returns ``None`` when the fleet is empty or fully excluded
        (every engine down/draining): the caller must hold the request
        pending and retry — a defined outcome, never a crash and never a
        dispatch onto a dead engine. No compensation is charged and no
        round-robin state is consumed on a ``None`` return."""
        engines = self._engines()
        if not engines:
            self.decisions["no_engine"] = self.decisions.get(
                "no_engine", 0) + 1
            return None
        traces = {e: self.traces.get(e) for e in engines}

        # line 1-2: incomplete traces -> ordered dispatch
        if any(t is None for t in traces.values()):
            self.decisions["fallback"] += 1
            chosen = self._ordered_next(engines)
            self._add_compensation(chosen, prefill_tokens, now)
            return chosen

        # line 6-9: KV protection path. Runs BEFORE affinity is even
        # computed: a cache hit must never pull load onto an engine whose
        # KV pool is the cluster's pressure point.
        kv = {e: t.kv_usage for e, t in traces.items()}
        e_min = min(engines, key=lambda e: (kv[e], e))
        e_max = max(engines, key=lambda e: (kv[e], -e))
        if kv[e_max] >= self.cfg.high_kv and \
                kv[e_max] - kv[e_min] >= self.cfg.large_gap:
            self.decisions["kv_path"] += 1
            self._add_compensation(e_min, prefill_tokens, now)
            return e_min

        # line 10-12: pressure scores (affinity-free: the CLOSE band must
        # keep judging the jittery trace signals, so the credit can never
        # manufacture or suppress a CLOSE verdict)
        scores = {e: self.score(traces[e], now) for e in engines}
        s_min = min(scores.values())
        s_max = max(scores.values())
        estimates = self._affinity_estimates(traces, prompt_tokens)
        w = self.cfg.affinity_weight

        # line 13-16: CLOSE guard. Within the band, affinity replaces the
        # arbitrary round-robin pick with the cache-holding engine — a
        # deterministic, sticky tiebreak, so no oscillation on jitter.
        band = max(self.cfg.close_abs,
                   self.cfg.close_rel * max(abs(s_max), 1.0),
                   0.05 * prefill_tokens)
        if s_max - s_min <= band:
            if estimates is not None:
                self.decisions["affinity_path"] += 1
                c_max = max(estimates.values())
                chosen = min((e for e in engines if estimates[e] == c_max),
                             key=lambda e: (scores[e], kv[e], e))
            else:
                self.decisions["close_path"] += 1
                chosen = self._ordered_next(engines)
            return self._charge_dispatch(chosen, prefill_tokens,
                                         estimates, now)

        # line 17: argmin by (score, kv, id), cache-hit credit included
        # (score() is linear in the credit, so subtract in place)
        self.decisions["score_path"] += 1
        if estimates is not None:
            scores = {e: scores[e] - w * estimates[e] for e in engines}
        chosen = min(engines, key=lambda e: (scores[e], kv[e], e))
        return self._charge_dispatch(chosen, prefill_tokens, estimates, now)


class BaselineScheduler:
    """vLLM-style baselines for the benchmark harness."""

    def __init__(self, trace_table: TraceTable, policy: str = "round_robin"):
        assert policy in ("round_robin", "least_requests")
        self.traces = trace_table
        self.policy = policy
        self._rr = itertools.count()
        self._inflight: Dict[int, int] = {}
        self._excluded: set = set()
        self.decisions: Dict[str, int] = {}

    # health/elastic exclusion — same contract as GimbalScheduler, so the
    # EngineHealthMonitor and the cluster loop work against either
    def exclude(self, engine_id: int) -> None:
        self._excluded.add(engine_id)

    def include(self, engine_id: int) -> None:
        self._excluded.discard(engine_id)

    def healthy_engines(self) -> List[int]:
        return [e for e in self.traces.engine_ids
                if e not in self._excluded]

    def select_engine(self, prefill_tokens: float, now: float = 0.0,
                      prompt_tokens=None) -> Optional[int]:
        engines = self.healthy_engines()
        if not engines:
            return None      # hold pending (same contract as Gimbal)
        if self.policy == "round_robin":
            return engines[next(self._rr) % len(engines)]
        # least_requests: request-count dispatch (coarse signal, the paper's
        # motivating strawman)
        def count(e):
            t = self.traces.get(e)
            base = (t.n_running + t.n_waiting) if t is not None else 0
            return base + self._inflight.get(e, 0)
        chosen = min(engines, key=lambda e: (count(e), e))
        self._inflight[chosen] = self._inflight.get(chosen, 0) + 1
        return chosen

    def on_trace_refresh(self, engine_id: int) -> None:
        self._inflight[engine_id] = 0
