"""Synthetic source-dependent expert-routing traffic (simulated data plane).

Reproduces the two routing phenomena the paper measures (Fig. 3/4): skewed
expert popularity (Zipf hotspots per layer) and *source-dependent* traffic
(each DP source tilts toward its own expert subset, drifting slowly over
time). ``shift_every_tokens`` adds scheduled routing NON-stationarity: the
hot-expert set rotates continuously along the expert axis (the zipf_shift
scenario's drifting skew, which predictive placement forecasts ahead of).
The real data plane gets these statistics from actual router outputs; the
simulator draws from this model.
"""
from __future__ import annotations

import numpy as np


class SourceExpertTraffic:
    def __init__(self, n_layers: int, n_experts: int, n_sources: int, *,
                 zipf_a: float = 1.4, source_tilt: float = 4.0,
                 drift: float = 0.02, seed: int = 0,
                 shift_every_tokens: int = 0, shift_roll: int = 0):
        self.L, self.E, self.S = n_layers, n_experts, n_sources
        self.drift = drift
        rng = np.random.default_rng(seed)
        self._rng = rng
        base = (1.0 / np.arange(1, n_experts + 1) ** zipf_a)
        self.pref = np.zeros((n_layers, n_sources, n_experts))
        for l in range(n_layers):
            pop = rng.permutation(base)             # layer-wise hotspots
            for s in range(n_sources):
                tilt = np.ones(n_experts)
                fav = rng.choice(n_experts, size=max(n_experts // 8, 1),
                                 replace=False)
                tilt[fav] *= source_tilt            # source-favored experts
                p = pop * tilt
                self.pref[l, s] = p / p.sum()
        # ---- routing non-stationarity (zipf_shift): the hot-expert set
        # rotates CONTINUOUSLY — every shift_every_tokens sampled, each
        # preference row has fully blended toward its roll-by-shift_roll
        # image, so hotspots drift along the expert axis at a steady,
        # seeded rate. This is the drifting-skew regime where reactive
        # placement always lags one window behind the traffic and a
        # short-horizon forecaster can aim ahead of it.
        self.shift_every = int(shift_every_tokens)
        self.shift_roll = int(shift_roll) if shift_roll > 0 \
            else max(n_experts // 8, 1)
        self._shift_acc = 0
        self.n_shifts = 0

    def maybe_drift(self) -> None:
        """Slow routing drift (what makes static placements go stale)."""
        if self._rng.random() < self.drift:
            l = self._rng.integers(0, self.L)
            s = self._rng.integers(0, self.S)
            p = self.pref[l, s]
            shift = self._rng.permutation(p) * 0.3 + p * 0.7
            self.pref[l, s] = shift / shift.sum()

    def _advance_shift(self, tokens: int) -> None:
        if self.shift_every <= 0 or tokens <= 0:
            return
        # convex blend toward the rolled hot set, a fraction proportional
        # to the tokens just sampled (rows stay normalized: both operands
        # sum to 1)
        f = min(tokens / self.shift_every, 1.0)
        rolled = np.roll(self.pref, self.shift_roll, axis=2)
        self.pref = (1.0 - f) * self.pref + f * rolled
        self._shift_acc += tokens
        while self._shift_acc >= self.shift_every:
            self._shift_acc -= self.shift_every
            self.n_shifts += 1

    def sample_counts(self, source: int, tokens: int, top_k: int
                      ) -> np.ndarray:
        """(L, E) expected routed counts (+Poisson noise) for one step."""
        lam = self.pref[:, source, :] * (tokens * top_k)
        out = self._rng.poisson(lam).astype(np.int64)
        self._advance_shift(tokens)
        return out
