"""The regions the launch tooling counts: each kernel wrapper's and each
collective's.

A kernel wrapper runs in the region of its kernel (the :func:`counted`
decorator), on its CUDA route and its plain route alike, and every
collective of ``distributed/sharding.py`` in a region of its own
(:func:`record`). The counters that read them live in the launch tooling:
``launch/cost.py::count_costs`` (FLOPs and bytes of one rank's program)
and ``launch/collective_analysis.py::count_collectives`` (each
collective's kind and output bytes). This module is the layer between:
the kernels and the policy import it, and it imports neither them nor the
tooling.

While a cost count is open, the outermost region adds its formula once (a
kernel's (FLOPs, bytes), a collective's output bytes as collective bytes)
and the counter counts no op inside it. With no count open and no span
recording a region costs a check of the module's state, so the serving
path pays nothing for it.

The same state holds the program's spans (:func:`span`, :func:`event`):
named, timed ranges of the serving path, each with its parent and its
attributes, kept in a bounded buffer (:func:`spans`). They record while a
``torch.profiler`` session is active or inside :func:`recording`, and each
kernel region adds one call of its kernel to the innermost open span.
While the profiler is active each span, recorded or not (the buffer may be
full), also opens a range of its name (``_RecordFunctionFast``, the
C++ form of ``record_function``): a session with CPU activity shows it on
the profiler's timeline, and a device-only session, which installs no
host-side callback, keeps nothing and pays one check in C++. With nothing
recording a span site costs one test of the two recording flags and
returns :data:`NULL`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


class _Null:
    """The region of a call not counted, and the span of a call not
    recorded: enters and leaves, takes attributes and keeps none, and is
    false."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _Null()

MAX_SPANS = 100_000      # records the buffer keeps; later spans are dropped

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Costs:
    """One run's sums. ``kernels``: name -> {"count", "flops", "bytes"} of
    the kernel regions."""
    flops: int = 0
    bytes: int = 0
    collective_bytes: int = 0
    ops: int = 0
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class Span:
    """One recorded span: its name, start and end (``time.perf_counter_ns``;
    an instant event has ``end_ns == start_ns``), the index in
    :func:`spans` of its parent (-1: none recorded), its attributes, and the
    hand-written kernels launched inside it and not inside a child (name ->
    calls)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    attrs: Dict[str, Any]
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)


class _State:
    def __init__(self):
        self.counter: Optional[Costs] = None   # the open cost count, if any
        self.depth = 0                 # kernel and collective regions open
        self.collectives: List[Dict[str, Dict[str, int]]] = []  # open counts
        self.recording = 0             # recording() blocks open
        self.buffer: List[Span] = []   # the recorded spans, in start order
        self.open: List["_LiveSpan"] = []  # recorded spans not yet ended
        self.dropped = 0               # spans not kept: the buffer was full


state = _State()


class _Region:
    """A kernel's or a collective's region: its formula is added once, at
    the outermost region, and no op inside is counted."""

    def __init__(self, name, formula, collective: bool):
        self.name, self.formula, self.collective = name, formula, collective

    def __enter__(self):
        outer = state.depth == 0
        state.depth += 1               # the formula's own ops count nowhere
        if outer and state.open and not self.collective:
            k = state.open[-1].rec.kernels
            k[self.name] = k.get(self.name, 0) + 1
        c = state.counter
        if outer and c is not None:
            flops, nbytes = self.formula()
            if self.collective:
                c.collective_bytes += int(nbytes)
            else:
                c.flops += int(flops)
                c.bytes += int(nbytes)
                k = c.kernels.setdefault(self.name, {"count": 0, "flops": 0,
                                                     "bytes": 0})
                k["count"] += 1
                k["flops"] += int(flops)
                k["bytes"] += int(nbytes)
        return self

    def __exit__(self, *exc):
        state.depth -= 1
        return False


def counted(name: str, formula: Callable[..., Tuple[float, float]]):
    """Decorator: the wrapped kernel wrapper runs in the region of kernel
    ``name``, whose (FLOPs, bytes) ``formula`` gives from the wrapper's own
    arguments, evaluated only while a cost count is open. While a span is
    open, the innermost one counts the call."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if state.counter is None and not state.open:
                return fn(*args, **kwargs)
            with _Region(name, lambda: formula(*args, **kwargs), False):
                return fn(*args, **kwargs)
        return run
    return wrap


def record(kind: str, t, parts: int = 1):
    """The region of one collective of ``kind`` (one of
    :data:`COLLECTIVES`) whose output is ``parts`` blocks of ``t`` (an
    all-gather over ``parts`` ranks; 1 for an all-reduce): its bytes in
    ``t``'s own dtype."""
    if not state.collectives and state.counter is None:
        return NULL
    nbytes = t.numel() * t.element_size() * parts
    for out in state.collectives:
        out[kind]["count"] += 1
        out[kind]["bytes"] += nbytes
    if state.counter is None:
        return NULL
    return _Region("", lambda: (0, nbytes), collective=True)


# ---------------------------------------------------------------- spans
class _Range(_Null):
    """A span the full buffer does not keep: only its profiler range."""

    def __init__(self, name: str):
        self.range = _RecordFunctionFast(name)

    def __enter__(self):
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        return False


class _LiveSpan:
    """A span that records: its record enters the buffer as it begins. Its
    interval holds its own bookkeeping and range, so the time between two
    spans is the caller's alone."""
    __slots__ = ("rec", "index", "range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.rec = Span(name, 0, 0, -1, attrs)
        self.index = -1                # the record's place in the buffer
        self.range = None              # the profiler's range, if one is open

    def __enter__(self):
        self.rec.start_ns = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self.range = _RecordFunctionFast(self.rec.name)
            self.range.__enter__()
        if state.open:
            self.rec.parent = state.open[-1].index
        self.index = len(state.buffer)
        state.buffer.append(self.rec)
        state.open.append(self)
        return self

    def __exit__(self, *exc):
        state.open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec.end_ns = time.perf_counter_ns()
        return False

    def __bool__(self):
        return True

    def set(self, **attrs) -> None:
        """Add attributes, such as counts known only at the span's end."""
        self.rec.attrs.update(attrs)


def span(name: str, **attrs):
    """The span ``name`` around a ``with`` block, with ``attrs`` (add more
    with ``.set(...)`` on what the ``with`` gives). While nothing records
    it is :data:`NULL`; while the buffer is full, only the profiler's
    range. Both are false and keep nothing."""
    profiling = _profiler._is_profiler_enabled
    if not (state.recording or profiling):
        return NULL
    if len(state.buffer) >= MAX_SPANS:
        state.dropped += 1
        return _Range(name) if profiling else NULL
    return _LiveSpan(name, attrs)


def event(name: str, **attrs) -> None:
    """An instant event ``name`` inside the innermost open span."""
    if not (state.recording or _profiler._is_profiler_enabled):
        return
    if len(state.buffer) >= MAX_SPANS:
        state.dropped += 1
        return
    t = time.perf_counter_ns()
    state.buffer.append(Span(name, t, t, state.open[-1].index
                             if state.open else -1, attrs))


def inherited(key: str, default=None):
    """The attribute ``key`` of the innermost open span that has it."""
    for live in reversed(state.open):
        if key in live.rec.attrs:
            return live.rec.attrs[key]
    return default


@contextlib.contextmanager
def recording():
    """Record spans inside, with or without a profiler session."""
    state.recording += 1
    try:
        yield
    finally:
        state.recording -= 1


def spans() -> List[Span]:
    """The recorded spans, in the order they began (a span's ``parent``
    indexes this list)."""
    return list(state.buffer)


def clear_spans() -> None:
    """Empty the buffer. Not while a recorded span is open."""
    if state.open:
        raise RuntimeError("clear_spans: a recorded span is still open")
    state.buffer.clear()
    state.dropped = 0
