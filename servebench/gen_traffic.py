"""The benchmark's one traffic generator, driven by a mix's data file.

A frozen copy of the port's generators, so that a later change to the
program cannot change the yardstick:

* prompt lengths: ``repro_torch/workloads/burstgpt.py::_lengths``'s
  ``random`` distribution (lognormal(6.8, 1.2), BurstGPT-shaped), or a
  uniform range;
* output lengths: ``burstgpt.generate_trace``'s lognormal around
  ``mean_output`` with sigma 0.6, clipped;
* arrivals: ``generate_trace``'s gaps, exponential (Poisson) or gamma with
  CV = sqrt(burstiness);
* token ids: each request has one of ``n_topics`` topics, and each topic
  draws ids Zipf(``zipf_a``) over its own seeded permutation of the
  vocabulary, so expert load is skewed and depends on the source engine.

The sizes (lengths and gaps) come from the mix's fixed ``shape_seed``;
``--seed`` draws every token id. So every seed serves one fixed trace, the
same sizes and arrivals in the same order: a seed changes the tokens (and,
through them, the routing), not the amount of work. The window's tails
are sensitive to the order of a burst's prompts: shuffled within blocks
of 8, TTFT's median moved by a third from seed to seed while two runs of
one seed agreed within 6%.

Arrival times are on the cluster's round clock: request ``i`` is due in
round ``ceil(arrival_i / dt)``. A mix may preload its first requests, all
due in round 0.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class TrafficRequest:
    """One generated request, before it becomes the program's ``Request``."""
    req_id: int
    prompt: np.ndarray          # int32 token ids
    max_new_tokens: int
    arrival_round: float        # in rounds (may be fractional)


def _prompt_lengths(spec: dict, n: int, rng: np.random.Generator):
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = rng.lognormal(mean=float(spec["mu"]), sigma=float(spec["sigma"]),
                          size=n)
    elif spec["dist"] == "uniform":
        x = rng.uniform(lo, hi + 1, size=n)
    else:
        raise ValueError(f"unknown prompt distribution {spec['dist']!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def _output_lengths(spec: dict, n: int, rng: np.random.Generator):
    x = rng.lognormal(np.log(float(spec["mean"])), float(spec["sigma"]), n)
    return np.clip(x, int(spec["min"]), int(spec["max"])).astype(np.int64)


def _unit_gaps(spec: dict, n: int, rng: np.random.Generator):
    """Inter-arrival gaps at a rate of one request per round."""
    b = float(spec.get("burstiness", 1.0))
    if spec["process"] == "poisson" or b == 1.0:
        return rng.exponential(1.0, n)
    if spec["process"] != "gamma":
        raise ValueError(f"unknown arrival process {spec['process']!r}")
    shape = 1.0 / b
    return rng.gamma(shape, 1.0 / shape, n)


def _seed_seq(seed: int, *salt: int) -> np.random.SeedSequence:
    # any whole number up to a little over 2**31 (and far beyond): split
    # into 32-bit words, as SeedSequence takes them
    s = int(seed)
    words = [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, 1 if s < 0 else 0]
    return np.random.SeedSequence(words + list(salt))


def generate(mix: dict, seed: int, vocab_size: int,
             n_requests: int) -> List[TrafficRequest]:
    """The first ``n_requests`` requests of ``mix`` under ``seed``."""
    # one stream per quantity, so that the first k requests are the same
    # whatever the number asked for
    shape = int(mix["shape_seed"])
    lens = _prompt_lengths(mix["prompt"], n_requests,
                           np.random.default_rng([shape, 0]))
    outs = _output_lengths(mix["output"], n_requests,
                           np.random.default_rng([shape, 1]))
    gaps = _unit_gaps(mix["arrivals"], n_requests,
                      np.random.default_rng([shape, 2]))
    # every request fits one block table: prompt + output <= max_total
    outs = np.minimum(outs, int(mix["max_total_tokens"]) - lens)
    # the first ``preload`` requests are all due in round 0 (a batch that
    # starts full); the arrivals follow them
    pre = int(mix.get("preload", 0))
    arrivals = np.zeros(n_requests)
    arrivals[pre:] = np.cumsum(gaps[pre:]) \
        / float(mix["arrivals"]["rate_per_round"])

    topics = mix["topics"]
    n_topics = int(topics["n"])
    prng = np.random.default_rng(_seed_seq(seed, 3))
    perms = np.stack([prng.permutation(vocab_size).astype(np.int32)
                      for _ in range(n_topics)])
    topic = np.random.default_rng(_seed_seq(seed, 4)).integers(
        0, n_topics, size=n_requests)
    ranks = (np.random.default_rng(_seed_seq(seed, 5)).zipf(
        float(topics["zipf_a"]), size=int(lens.sum())) - 1) % vocab_size
    ends = np.cumsum(lens)
    reqs = []
    for i in range(n_requests):
        r = ranks[ends[i] - lens[i]:ends[i]]
        reqs.append(TrafficRequest(
            req_id=i, prompt=perms[topic[i]][r], max_new_tokens=int(outs[i]),
            arrival_round=float(arrivals[i])))
    return reqs


def requests_for_rounds(mix: dict, rounds: int) -> int:
    """How many requests cover ``rounds`` rounds of arrivals, with room."""
    return int(np.ceil(float(mix["arrivals"]["rate_per_round"]) * rounds
                       * 1.25)) + 16
