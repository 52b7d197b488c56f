"""The traced stretch's device profile, reduced to what the readers need.

``torch.profiler`` traces the device alone (tracing the host's operations
too doubles a serve's wall time). The first device event is the marker the
recorder launched at the stretch's start, at a host stamp it kept, so the
device's clock maps onto the host's; idle gaps are then labelled by the
benchmark's host span that holds their midpoint: an engine step (and what
it did) or the control plane between steps.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

_FUNCTOR = re.compile(
    r"([A-Za-z_]\w*(?:Functor\w*|_kernel_impl|_kernel_cuda))\b")


def short_name(name: str) -> str:
    """A kernel's name without its template and parameter lists, with the
    functor of a PyTorch elementwise kernel beside it."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name, maxsplit=1)[0]
    m = _FUNCTOR.search(name[len(base):])
    return f"{base}[{m.group(1)}]" if m else base


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(run) -> dict:
    """{"busy_s", "window_s", "kernels": {name: seconds}, "gaps": {label:
    seconds}} of the traced stretch, all in seconds of the device's
    clock."""
    from torch.autograd import DeviceType
    rec = run.rec
    events = [e for e in rec.profiler.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    events.sort(key=lambda e: e.time_range.start)
    t0 = events[0].time_range.start                  # the marker, in us
    window_s = rec.trace_end - rec.trace_mark
    kernels: Dict[str, float] = defaultdict(float)
    spans = []
    for e in events[1:]:
        a = (e.time_range.start - t0) * 1e-6
        b = (e.time_range.end - t0) * 1e-6
        if b <= 0 or a >= window_s:
            continue
        a, b = max(a, 0.0), min(b, window_s)
        kernels[e.name] += b - a
        spans.append((a, b))
    busy = _merge(spans)
    busy_s = sum(b - a for a, b in busy)

    # host spans, on the stretch's clock (seconds since the marker)
    steps = [(s.t0 - rec.trace_mark, s.t1 - rec.trace_mark,
              f"engine step ({s.kind})") for s in rec.steps
             if s.t1 >= rec.trace_mark and s.t0 <= rec.trace_end]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [0.0] + [x for iv in busy for x in iv] + [window_s]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = next((name for s0, s1, name in steps if s0 <= mid <= s1),
                     "control plane (dispatch, traces, coordinator)")
        gaps[label] += b - a
    return {"busy_s": busy_s, "window_s": window_s, "kernels": dict(kernels),
            "gaps": dict(gaps)}


def breakdown(reduced: dict, top: int = 10) -> dict:
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    ops: Dict[str, float] = defaultdict(float)
    for name, s in reduced["kernels"].items():
        ops[short_name(name)] += s
    return {"device_ops": largest(ops),
            "idle_gaps": largest(reduced["gaps"])}


def kernel_seconds(reduced: dict, *parts: str) -> float:
    """Device seconds of the kernels whose name holds any of ``parts``."""
    return sum(s for name, s in reduced["kernels"].items()
               if any(p in name for p in parts))
