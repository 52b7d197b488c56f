"""BurstGPT-style serving workloads (paper §7.1, Figs. 1 and 7).

The paper reshapes the BurstGPT trace into five request-length
distributions: Random, Central, Descending, Two-end, Average. We generate
matching synthetic traces (the real CSV is not redistributable offline):
heavy-tailed lengths bounded to [16, 8192] like GPT-4 traffic in Fig. 1,
Poisson arrivals at a given RPS, and lognormal output lengths.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.serving.request import Request

DISTRIBUTIONS = ("random", "central", "descending", "two_end", "average")
LEN_MIN, LEN_MAX = 16, 8192


def _lengths(dist: str, n: int, rng: np.random.Generator) -> np.ndarray:
    if dist == "random":
        # heavy-tailed like the BurstGPT CDF: lognormal, clipped
        x = rng.lognormal(mean=6.8, sigma=1.2, size=n)
    elif dist == "central":
        x = rng.normal(loc=1800, scale=450, size=n)
    elif dist == "descending":
        # Determinism note: "descending" couples every request's length to
        # the WHOLE draw vector (request i gets the i-th largest of n
        # samples), so unlike the other distributions the per-request
        # lengths are only reproducible for the same (seed, n) pair —
        # truncating a trace is NOT the same as generating a shorter one.
        # stable sort + copy: a fixed total order (ties included) and a
        # contiguous array rather than a negative-stride view
        x = np.sort(rng.lognormal(6.8, 1.2, size=n),
                    kind="stable")[::-1].copy()
    elif dist == "two_end":
        short = rng.lognormal(4.5, 0.4, size=n)
        long = rng.lognormal(8.0, 0.3, size=n)
        pick = rng.random(n) < 0.5
        x = np.where(pick, short, long)
    elif dist == "average":
        x = np.full(n, 1800.0) + rng.normal(0, 64, size=n)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.clip(x, LEN_MIN, LEN_MAX).astype(np.int64)


def generate_trace(dist: str, n_requests: int, rps: float, *,
                   seed: int = 0, mean_output: float = 200.0,
                   burstiness: float = 1.0) -> List[Request]:
    """burstiness > 1 -> gamma inter-arrivals with CV = sqrt(burstiness)."""
    rng = np.random.default_rng(seed)
    lens = _lengths(dist, n_requests, rng)
    outs = np.clip(rng.lognormal(np.log(mean_output), 0.6, n_requests),
                   8, 2048).astype(np.int64)
    if burstiness == 1.0:
        gaps = rng.exponential(1.0 / rps, n_requests)
    else:
        shape = 1.0 / burstiness
        gaps = rng.gamma(shape, 1.0 / (rps * shape), n_requests)
    arrivals = np.cumsum(gaps)
    return [Request(req_id=i, prompt_len=int(lens[i]),
                    max_new_tokens=int(outs[i]),
                    arrival_time=float(arrivals[i]))
            for i in range(n_requests)]


def length_cdf(dist: str, n: int = 10000, seed: int = 0):
    """(lengths, cdf) pair for Fig. 1/7-style reporting."""
    rng = np.random.default_rng(seed)
    x = np.sort(_lengths(dist, n, rng))
    return x, np.arange(1, n + 1) / n
