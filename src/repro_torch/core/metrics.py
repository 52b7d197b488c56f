"""Streaming latency metrics: O(1)-memory quantiles + windowed series.

The million-request scenario harness (workloads/scenarios.py) needs
p50/p99 TTFT/TPOT/E2E over 10^5-10^6 requests without holding the raw
samples. Two estimators cover the two needs:

* :class:`P2Quantile` — the Jain & Chlamtac P-squared marker estimator:
  one quantile in O(1) memory (5 markers), the running *global* estimate
  the dashboards headline. P-squared markers cannot be merged, which is
  exactly why the windowed series below does NOT use them.
* :class:`ReservoirQuantile` — a seeded fixed-size uniform reservoir
  (Algorithm R). Reservoirs from different windows/planes merge by
  sample-count weighting (:func:`merged_quantile`), so per-window
  sketches compose into whole-run or cross-scenario percentiles.

:class:`StreamingStat` bundles count/sum/min/max with both estimators;
:class:`WindowedSeries` buckets observations into fixed-width virtual
time windows (one small sketch per window — the dashboard time series);
:class:`StreamingMetrics` is the named registry both serving planes feed
(``ttft``/``tpot``/``e2e``) and the scenario driver snapshots into
``BENCH_scenarios.json``.

Everything is deterministic per seed: reservoir replacement draws come
from one ``numpy`` generator seeded at construction, so a scenario run
is reproducible sample-for-sample.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


class P2Quantile:
    """Single-quantile P-squared estimator (Jain & Chlamtac 1985).

    Maintains 5 markers whose heights approximate the q-quantile with a
    piecewise-parabolic update; exact (sorted buffer) below 5 samples.
    """

    def __init__(self, q: float):
        assert 0.0 < q < 1.0, "quantile must be in (0, 1)"
        self.q = q
        self.n = 0
        self._heights: List[float] = []          # marker heights (5)
        self._pos: List[float] = []              # marker positions (int-ish)
        self._des: List[float] = []              # desired positions

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._heights.append(x)
            self._heights.sort()
            if self.n == 5:
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._des = [1.0, 1.0 + 2.0 * self.q, 1.0 + 4.0 * self.q,
                             3.0 + 2.0 * self.q, 5.0]
            return
        h, pos, des = self._heights, self._pos, self._des
        # ---- find the cell and bump marker positions
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x < h[i]:
                    break
                k = i
        for i in range(k + 1, 5):
            pos[i] += 1.0
        incr = (0.0, self.q / 2.0, self.q, (1.0 + self.q) / 2.0, 1.0)
        for i in range(5):
            des[i] += incr[i]
        # ---- adjust interior markers toward their desired positions
        for i in range(1, 4):
            d = des[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
               (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                s = 1.0 if d >= 1.0 else -1.0
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:                              # linear fallback
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, p = self._heights, self._pos
        return h[i] + s / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + s) * (h[i + 1] - h[i]) / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - s) * (h[i] - h[i - 1]) / (p[i] - p[i - 1]))

    @property
    def value(self) -> float:
        if self.n == 0:
            return float("nan")
        if self.n <= 5 or not self._pos:
            k = min(max(int(round(self.q * (len(self._heights) - 1))), 0),
                    len(self._heights) - 1)
            return sorted(self._heights)[k]
        return self._heights[2]


class ReservoirQuantile:
    """Seeded uniform reservoir (Algorithm R) with weighted merging."""

    def __init__(self, k: int = 512, seed: int = 0):
        self.k = int(k)
        self.n = 0
        self._buf = np.empty(self.k, dtype=np.float64)
        self._rng = np.random.default_rng(seed)

    def observe(self, x: float) -> None:
        if self.n < self.k:
            self._buf[self.n] = x
        else:
            j = int(self._rng.integers(0, self.n + 1))
            if j < self.k:
                self._buf[j] = x
        self.n += 1

    @property
    def samples(self) -> np.ndarray:
        return self._buf[:min(self.n, self.k)]

    def quantile(self, q: float) -> float:
        s = self.samples
        if s.size == 0:
            return float("nan")
        return float(np.quantile(s, q))


def merged_quantile(reservoirs: Sequence[ReservoirQuantile],
                    q: float) -> float:
    """Quantile over the union stream several reservoirs observed.

    Each reservoir's samples stand for ``n / len(samples)`` originals, so
    the merge is a weighted quantile — deterministic (no re-sampling) and
    correct for windows of very different populations.
    """
    vals, wts = [], []
    for r in reservoirs:
        s = r.samples
        if s.size:
            vals.append(s)
            wts.append(np.full(s.size, r.n / s.size))
    if not vals:
        return float("nan")
    v = np.concatenate(vals)
    w = np.concatenate(wts)
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cw = np.cumsum(w)
    target = q * cw[-1]
    return float(v[int(np.searchsorted(cw, target, side="left")
                       .clip(0, v.size - 1))])


class StreamingStat:
    """count/sum/min/max + P-squared per quantile + one reservoir."""

    def __init__(self, quantiles: Tuple[float, ...] = DEFAULT_QUANTILES,
                 reservoir_k: int = 512, seed: int = 0):
        self.quantiles = tuple(quantiles)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._p2 = {q: P2Quantile(q) for q in self.quantiles}
        self.reservoir = ReservoirQuantile(reservoir_k, seed=seed)

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        for est in self._p2.values():
            est.observe(x)
        self.reservoir.observe(x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """P-squared estimate when tracked, reservoir estimate otherwise."""
        if q in self._p2:
            return self._p2[q].value
        return self.reservoir.quantile(q)

    def snapshot(self) -> Dict[str, float]:
        out = {"count": self.count, "mean": self.mean,
               "min": self.min if self.count else float("nan"),
               "max": self.max if self.count else float("nan")}
        for q in self.quantiles:
            out[f"p{round(q * 100) if q * 100 == int(q * 100) else q * 100:g}"
                ] = self.quantile(q)
        return out


@dataclasses.dataclass
class _Window:
    t0: float
    t1: float
    stat: StreamingStat


class WindowedSeries:
    """Fixed-width virtual-time windows of one metric (dashboard series).

    Windows hold reservoirs (mergeable) rather than P-squared markers
    (not mergeable): :meth:`merged` reconstructs whole-run quantiles from
    the closed windows, which the scenario invariant pack cross-checks
    against the global estimator.
    """

    def __init__(self, window_s: float = 30.0,
                 quantiles: Tuple[float, ...] = DEFAULT_QUANTILES,
                 reservoir_k: int = 128, seed: int = 0,
                 max_windows: int = 4096):
        assert window_s > 0
        self.window_s = float(window_s)
        self.quantiles = tuple(quantiles)
        self.reservoir_k = int(reservoir_k)
        self.seed = seed
        self.max_windows = int(max_windows)
        self.windows: List[_Window] = []
        self._dropped = 0                  # windows evicted past the cap

    def observe(self, t: float, x: float) -> None:
        idx = int(t // self.window_s)
        w = self.windows[-1] if self.windows else None
        if w is None or t >= w.t1:
            w = _Window(idx * self.window_s, (idx + 1) * self.window_s,
                        StreamingStat(self.quantiles, self.reservoir_k,
                                      seed=self.seed + len(self.windows)
                                      + self._dropped))
            self.windows.append(w)
            if len(self.windows) > self.max_windows:   # bound memory
                self.windows.pop(0)
                self._dropped += 1
        elif t < w.t0:
            # late observation (cross-engine finish reordering): fold into
            # the current window rather than reopening a closed one — the
            # series stays monotone in window start time
            pass
        w.stat.observe(x)

    def merged(self, q: float) -> float:
        return merged_quantile([w.stat.reservoir for w in self.windows], q)

    def snapshot(self) -> List[Dict[str, float]]:
        return [{"t0": w.t0, "t1": w.t1, **w.stat.snapshot()}
                for w in self.windows]


class StreamingMetrics:
    """Named metric registry both serving planes feed at request finish.

    ``observe_request`` records the standard serving latencies; arbitrary
    named metrics work through ``observe``. Memory is O(quantiles +
    reservoir_k + windows), independent of the request count.
    """

    def __init__(self, quantiles: Tuple[float, ...] = DEFAULT_QUANTILES,
                 window_s: float = 30.0, reservoir_k: int = 512,
                 seed: int = 0, max_windows: int = 4096):
        self.quantiles = tuple(quantiles)
        self.window_s = float(window_s)
        self.reservoir_k = int(reservoir_k)
        self.seed = seed
        self.max_windows = int(max_windows)
        self._global: Dict[str, StreamingStat] = {}
        self._series: Dict[str, WindowedSeries] = {}
        self.n_requests = 0

    def _stat(self, name: str) -> StreamingStat:
        if name not in self._global:
            self._global[name] = StreamingStat(
                self.quantiles, self.reservoir_k,
                seed=self.seed + len(self._global))
            self._series[name] = WindowedSeries(
                self.window_s, self.quantiles,
                max(self.reservoir_k // 4, 16),
                seed=self.seed + 7919 * (len(self._series) + 1),
                max_windows=self.max_windows)
        return self._global[name]

    def observe(self, name: str, value: float, t: float = 0.0) -> None:
        self._stat(name).observe(value)
        self._series[name].observe(t, value)

    def observe_request(self, r) -> None:
        """Record one finished, non-error request's latencies at its
        virtual finish time (the window axis is virtual time)."""
        t = r.finish_time
        self.n_requests += 1
        self.observe("ttft", r.ttft, t)
        self.observe("e2e", r.e2e, t)
        if r.generated > 1:                 # tpot undefined for 1 token
            self.observe("tpot", r.tpot, t)

    def quantile(self, name: str, q: float) -> float:
        if name not in self._global:
            return float("nan")
        return self._global[name].quantile(q)

    def merged_window_quantile(self, name: str, q: float) -> float:
        if name not in self._series:
            return float("nan")
        return self._series[name].merged(q)

    def snapshot(self, series: bool = False) -> Dict:
        out = {"n_requests": self.n_requests,
               "window_s": self.window_s,
               "metrics": {n: s.snapshot()
                           for n, s in self._global.items()}}
        if series:
            out["series"] = {n: w.snapshot()
                             for n, w in self._series.items()}
        return out
