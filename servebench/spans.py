"""The program's own spans inside the traced stretch, for the readers of
the ``program_span`` metrics that the port records itself.

The port records spans (``repro_torch.counting.span``) while a
``torch.profiler`` session is active, as it is over the traced stretch.
They are stamped by ``time.perf_counter_ns``, the clock of the recorder's
marks, so the stretch is ``[rec.trace_mark, rec.trace_end]``. A run that
was not traced, or a program that records no spans, gives None.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def traced(run) -> Optional[Dict[int, object]]:
    """{index in ``counting.spans()``: span} of the spans that lie wholly
    inside the traced stretch, or None."""
    rec = run.rec
    if rec.trace_mark is None or rec.trace_end is None:
        return None
    try:
        from repro_torch import counting
    except ImportError:
        return None
    read = getattr(counting, "spans", None)
    if read is None:
        return None
    a, b = rec.trace_mark * 1e9, rec.trace_end * 1e9
    found = {i: s for i, s in enumerate(read())
             if s.start_ns >= a and s.end_ns <= b}
    return found or None


def seconds(span) -> float:
    return (span.end_ns - span.start_ns) * 1e-9


def working_steps(found: Dict[int, object]) -> List[Tuple[int, object]]:
    """The ``engine.step`` spans of steps that dispatched the model."""
    return [(i, s) for i, s in found.items() if s.name == "engine.step"
            and s.attrs.get("dispatches", 0) > 0]


def child_seconds(found: Dict[int, object], name: str) -> Dict[int, float]:
    """Parent index -> seconds in its children called ``name``."""
    out: Dict[int, float] = defaultdict(float)
    for s in found.values():
        if s.name == name:
            out[s.parent] += seconds(s)
    return out
