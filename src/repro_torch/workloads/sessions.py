"""Multi-turn session traces: requests re-arrive with grown prefixes.

Agentic / chat traffic is not one-shot: a session's turn ``k+1`` carries
the full prior conversation as its prompt — the previous prompt, the
(modeled) assistant reply, and the new user message. That re-arrival
pattern stresses the radix prefix cache and the affinity dispatch in
ways one-shot BurstGPT traces never do: the cached chain *grows* between
hits, and the scheduler must keep steering a session to the engine
holding its (ever longer) prefix.

Guarantees (property-tested in tests/test_scenarios.py):

* **true-prefix** — within a session, turn ``k``'s ``prompt_tokens`` is
  an exact prefix of turn ``k+1``'s (token-for-token, by construction:
  the history list only ever appends);
* **determinism** — one seeded generator, fixed draw order: the same
  ``(seed, n_requests, cfg)`` reproduces the trace token-for-token;
* **monotone arrivals** — globally sorted; within a session strictly
  increasing (service estimate + think time between turns).

The assistant reply folded into the next prompt is *synthesized* (the
generator cannot know what an engine will sample). On the real plane the
radix cache registers the actual generated tokens, so a session's cache
hit covers the previous turn's full registered prompt — the grown-prefix
property the harness measures holds on both planes either way. Pass
``fold_assistant=False`` for sim-real differential slices where the two
planes' caches must stay token-identical.

Requests get ``session_id`` / ``turn`` attributes (trace metadata the
invariant pack and the tests read; the serving stack ignores them).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Shape of one synthetic multi-turn session population."""

    mean_turns: float = 4.0            # geometric; >= 1
    max_turns: int = 12
    base_prompt: tuple = (48, 192)     # first-turn prompt tokens [lo, hi]
    user_tokens: tuple = (8, 48)       # new user tokens per later turn
    output_tokens: tuple = (16, 64)    # per-turn max_new_tokens [lo, hi]
    think_time_s: float = 2.0          # exponential mean between turns
    vocab: int = 256                   # token id range [0, vocab)
    fold_assistant: bool = True        # fold the modeled reply into the
                                       # next turn's prompt (see module doc)
    # open-loop service estimate spacing the next turn past the previous
    # one (the generator cannot observe real finish times): prefill tokens
    # per second and seconds per output token, deliberately coarse
    est_prefill_tps: float = 20_000.0
    est_tpot_s: float = 0.02

    def clipped(self, max_prompt: int) -> "SessionConfig":
        """Bound every length so final-turn prompts fit ``max_prompt``
        (real-plane slices: page table capacity is small)."""
        worst_turns = self.max_turns
        out_hi = self.output_tokens[1] if self.fold_assistant else 0
        per_turn = self.user_tokens[1] + out_hi
        base_hi = max(max_prompt - (worst_turns - 1) * per_turn, 4)
        return dataclasses.replace(
            self, base_prompt=(min(self.base_prompt[0], base_hi),
                               min(self.base_prompt[1], base_hi)))


def _draw_len(rng: np.random.Generator, lohi) -> int:
    lo, hi = int(lohi[0]), int(lohi[1])
    return int(rng.integers(lo, hi + 1)) if hi > lo else lo


def generate_sessions(n_requests: int, session_rps: float,
                      cfg: Optional[SessionConfig] = None, *,
                      seed: int = 0, start_id: int = 0) -> List[Request]:
    """Generate ``n_requests`` turn-requests across Poisson-arriving
    sessions. Returns requests sorted by arrival with contiguous req_ids
    starting at ``start_id``."""
    cfg = cfg or SessionConfig()
    assert cfg.mean_turns >= 1.0 and cfg.max_turns >= 1
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    session_id = 0
    t_session = 0.0
    while len(out) < n_requests:
        t_session += float(rng.exponential(1.0 / session_rps))
        p_stop = min(1.0 / cfg.mean_turns, 1.0)
        n_turns = min(int(rng.geometric(p_stop)), cfg.max_turns)
        hist: List[int] = list(
            rng.integers(0, cfg.vocab, _draw_len(rng, cfg.base_prompt)))
        t = t_session
        for turn in range(n_turns):
            if len(out) >= n_requests:
                break
            prompt = [int(x) for x in hist]
            out_len = _draw_len(rng, cfg.output_tokens)
            r = Request(req_id=0, prompt_len=len(prompt),
                        max_new_tokens=out_len, arrival_time=t,
                        prompt_tokens=prompt)
            r.session_id = session_id          # trace metadata (tests,
            r.turn = turn                      # invariant pack)
            out.append(r)
            # grow the history for the next turn: modeled assistant reply
            # (same length the engine will actually generate) + user text
            reply = rng.integers(0, cfg.vocab, out_len)
            if cfg.fold_assistant:
                hist.extend(int(x) for x in reply)
            hist.extend(int(x) for x in rng.integers(
                0, cfg.vocab, _draw_len(rng, cfg.user_tokens)))
            est = len(prompt) / cfg.est_prefill_tps \
                + out_len * cfg.est_tpot_s
            t += est + float(rng.exponential(cfg.think_time_s))
        session_id += 1
    out.sort(key=lambda r: (r.arrival_time, r.session_id, r.turn))
    for i, r in enumerate(out):
        r.req_id = start_id + i
    return out


def session_stats(requests: List[Request]) -> dict:
    """Aggregate trace statistics (dashboard/reporting helper)."""
    sessions = {}
    for r in requests:
        sessions.setdefault(getattr(r, "session_id", -1), []).append(r)
    turns = np.asarray([len(v) for v in sessions.values()])
    lens = np.asarray([r.prompt_len for r in requests])
    return {
        "n_sessions": len(sessions),
        "n_requests": len(requests),
        "mean_turns": float(turns.mean()) if turns.size else 0.0,
        "max_turns": int(turns.max()) if turns.size else 0,
        "mean_prompt_len": float(lens.mean()) if lens.size else 0.0,
        "max_prompt_len": int(lens.max()) if lens.size else 0,
    }
