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
and the counter counts no op inside it. With no count open a region costs
one check of a module-level flag, so the serving path pays nothing for it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

NULL = contextlib.nullcontext()      # the region of a call not counted

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


class _State:
    def __init__(self):
        self.counter: Optional[Costs] = None   # the open cost count, if any
        self.depth = 0                 # kernel and collective regions open
        self.collectives: List[Dict[str, Dict[str, int]]] = []  # open counts


state = _State()


class _Region:
    """A kernel's or a collective's region: its formula is added once, at
    the outermost region, and no op inside is counted."""

    def __init__(self, name, formula, collective: bool):
        self.name, self.formula, self.collective = name, formula, collective

    def __enter__(self):
        outer = state.depth == 0
        state.depth += 1               # the formula's own ops count nowhere
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
    arguments, evaluated only while a cost count is open."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if state.counter is None:
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
