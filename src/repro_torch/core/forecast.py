"""Online source→expert traffic forecasting + prefetch cost model.

PROBE and "Patterns behind Chaos" (PAPERS.md) show MoE expert-activation
traffic is forecastable in real time over short horizons. This module
turns the profiler's per-window ``(B[l,e], A[l,s,e])`` snapshots into a
one-window-ahead forecast ``(B̂, Â)`` that the placement heuristic can
rebalance *toward* instead of chasing the last window:

- :class:`ExpertTrafficForecaster` — Holt-style level+trend smoothing per
  (layer, source, expert) entry (``mode="ema"`` drops the trend term).
  Forecast quality is tracked as an EMA of the normalized per-window L1
  error (``forecast_mae``) next to the persistence baseline's error
  (``naive_mae`` — last window as-is, i.e. what reactive placement
  implicitly assumes); when the model forecast is *worse* than
  persistence the predictor falls back to reactive counts, so a
  degraded forecaster can never do worse than the reactive pipeline.
  ``horizon=0`` passes the observed arrays through untouched — the
  predictive pipeline then bit-reproduces reactive placement
  decision-for-decision (tested).

- :class:`PrefetchCostModel` — prices an asynchronous expert-weight
  prefetch (copy a migrating expert's stacked FFN weights to the target
  rank, overlapped with serving) the same way ``SwapCostModel`` prices
  KV swaps: an EMA over *measured* transfer observations replaces the
  datasheet seed within a few copies. The coordinator uses it to decide
  when a staged placement's weights have landed and the pointer flip
  can happen off the serving path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    mode: str = "linear"           # "linear" (level+trend) | "ema" (level)
    horizon: int = 1               # windows ahead; 0 = reactive passthrough
    ema_alpha: float = 0.5         # newest-window weight in the level
    trend_alpha: float = 0.4       # newest-delta weight in the trend
    err_alpha: float = 0.3         # EMA weight of the per-window error
    min_windows: int = 2           # history before the model predicts
    # fall back to reactive counts when the model's tracked error is both
    # worse than persistence AND above this absolute normalized-L1 floor
    # (persistence can look "beaten" on noise alone; the floor keeps a
    # healthy forecaster from flapping on tiny error differences)
    fallback_rel_mae: float = 0.9


class ExpertTrafficForecaster:
    """Per-entry Holt forecaster over windowed (B, A) expert statistics."""

    def __init__(self, n_layers: int, n_experts: int, n_sources: int,
                 cfg: Optional[ForecastConfig] = None):
        self.L, self.E, self.S = n_layers, n_experts, n_sources
        self.cfg = cfg or ForecastConfig()
        self._level: Optional[np.ndarray] = None     # (L, S, E)
        self._trend = np.zeros((n_layers, n_sources, n_experts))
        self._last: Optional[np.ndarray] = None      # previous window's A
        self._pred: Optional[np.ndarray] = None      # model forecast for the
                                                     # window being served
        self.n_windows = 0
        self.fallback_windows = 0
        self.forecast_mae = 0.0    # EMA of |Â - A|_1 / |A|_1 per window
        self.naive_mae = 0.0       # same for the persistence baseline

    # ---- window lifecycle ------------------------------------------------
    def observe(self, B: np.ndarray, A: np.ndarray) -> None:
        """Fold one completed window's ACTUAL counts into the model.

        Call once per window, before :meth:`predict` for the next one.
        Error EMAs always track the *model's* forecast (not whatever the
        caller used after a fallback), so a degraded forecaster keeps
        being scored and can re-earn trust when traffic calms down.
        """
        del B   # B is A summed over sources; one model covers both
        a = np.asarray(A, np.float64)
        tot = float(a.sum())
        e = self.cfg.err_alpha
        if tot > 0:
            if self._pred is not None:
                mae = float(np.abs(self._pred - a).sum()) / tot
                self.forecast_mae = (1 - e) * self.forecast_mae + e * mae
            if self._last is not None:
                naive = float(np.abs(self._last - a).sum()) / tot
                self.naive_mae = (1 - e) * self.naive_mae + e * naive
        if self._level is None:
            self._level = a.copy()
        else:
            al, bt = self.cfg.ema_alpha, self.cfg.trend_alpha
            prev = self._level
            self._level = al * a + (1 - al) * (prev + self._trend)
            if self.cfg.mode == "linear":
                self._trend = bt * (self._level - prev) + (1 - bt) * \
                    self._trend
        self._last = a.copy()
        self._pred = None
        self.n_windows += 1

    @property
    def degraded(self) -> bool:
        """Model forecast measurably worse than just using last window."""
        return (self.n_windows >= self.cfg.min_windows
                and self.forecast_mae > self.naive_mae
                and self.forecast_mae > self.cfg.fallback_rel_mae)

    def predict(self, B: np.ndarray,
                A: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B̂, Â) for the next window; ``(B, A)`` are the just-observed
        reactive counts (the fallback, returned VERBATIM — same objects —
        at horizon 0 / cold start / degraded model)."""
        h = self.cfg.horizon
        if h <= 0:
            return B, A
        # the raw model forecast is scored against the next window even
        # when the caller gets the reactive fallback below
        model_ready = self._level is not None \
            and self.n_windows >= self.cfg.min_windows
        if model_ready:
            a_hat = self._level + (h * self._trend
                                   if self.cfg.mode == "linear" else 0.0)
            np.maximum(a_hat, 0.0, out=a_hat)
            # renormalize to the observed window's magnitude: placement
            # trades comm tokens against mig_cost_tokens, so the forecast
            # must stay in the same token units as the reactive counts
            tot = float(np.asarray(A).sum())
            hat_tot = float(a_hat.sum())
            if tot > 0 and hat_tot > 0:
                a_hat *= tot / hat_tot
            self._pred = a_hat
        if not model_ready or self.degraded:
            if model_ready:
                self.fallback_windows += 1
            return B, A
        return a_hat.sum(axis=1), a_hat


# --------------------------------------------------------------- prefetch
@dataclasses.dataclass
class PrefetchConfig:
    """Seeds for the measured prefetch-transfer model. ``bytes_per_expert``
    defaults to one Qwen3-30B-A3B expert's stacked gate+up+down FFN
    (3 * d_model * d_expert * 2B = 3 * 2048 * 768 * 2); real planes
    override it from the actual model config
    (``transformer.expert_weight_bytes``)."""

    bw_bytes_s: float = 4.0e10      # device-to-device expert-copy bandwidth
    lat_s: float = 2.0e-3           # per-prefetch launch/sync latency
    bytes_per_expert: float = 3 * 2048 * 768 * 2.0
    ema: float = 0.25               # observation weight


class PrefetchCostModel:
    """Measured cost of copying expert weights ahead of a placement flip."""

    def __init__(self, cfg: Optional[PrefetchConfig] = None):
        self.cfg = cfg or PrefetchConfig()
        self.bw = self.cfg.bw_bytes_s
        self.n_observed = 0

    def observe(self, nbytes: float, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        rate = nbytes / max(seconds - self.cfg.lat_s, 1e-9)
        self.bw = (1 - self.cfg.ema) * self.bw + self.cfg.ema * rate
        self.n_observed += 1

    def bytes_for(self, n_experts_moved: int) -> float:
        return n_experts_moved * self.cfg.bytes_per_expert

    def duration(self, nbytes: float) -> float:
        """Wall time until the staged weights have landed on the target."""
        return self.cfg.lat_s + nbytes / max(self.bw, 1e-9)
