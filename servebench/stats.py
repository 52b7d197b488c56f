"""Exact order statistics over a window's samples."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0..1) of ``values`` by linear interpolation
    between order statistics (numpy's default), or None for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_s(run) -> List[float]:
    """TTFT of every request due in the window: from the start of the
    round that dispatches it to the end of the step that emitted its first
    token, or to the window's close for one still without a token."""
    rec = run.rec
    return [(min(r.first_wall, rec.t_close) if r.first_wall is not None
             else rec.t_close) - r.due_wall for r in run.due_requests()]


def tpot_s(run) -> List[float]:
    """For each request with two or more tokens in the window, the mean
    gap between them: first to last token in the window, over the gaps."""
    return [(r.window_tokens[-1] - r.window_tokens[0])
            / (len(r.window_tokens) - 1)
            for r in run.rec.reqs.values() if len(r.window_tokens) >= 2]


def round_walls(run) -> Dict[int, float]:
    """Wall seconds of each window round outside the traced stretch."""
    rs = run.rec.round_start
    return {r: rs[r + 1] - rs[r] for r in run.window_rounds()
            if r + 1 in rs}


def traced_steps(run):
    """The engine steps inside the traced stretch."""
    a, b = run.trace_excluded[0], run.trace_excluded[-1]
    return [s for s in run.rec.steps if a <= s.round < b]
