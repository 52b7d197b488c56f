"""Collective byte accounting for the roofline: the port's counterpart of
the reference's ``launch/hlo_analysis.py``.

The reference parses the compiled HLO text for every all-gather,
all-reduce, reduce-scatter, all-to-all and collective-permute. The port has
no HLO: its collectives are explicit calls, every one through
``ShardingPolicy._reduce`` or ``_gather`` (``distributed/sharding.py``),
and each of those runs in the region of ``counting.record``. While
:func:`count_collectives` is open, a call adds its kind and the bytes of
its output in the tensor's own dtype, as the reference counts "output
shape bytes of each collective" (not gloo's f32 host copy). A collective over one rank runs nothing and records
nothing. The port fills ``all-reduce`` and ``all-gather``; the other three
kinds stay in the result, at zero, in the reference's shape.

A recorded collective is also a region of ``launch/cost.py``'s counter:
its output counts as collective bytes there, and the ops inside it
(staging copies, the concatenation of the parts) as no memory traffic.
"""
from __future__ import annotations

import contextlib
from typing import Dict

from repro_torch.counting import COLLECTIVES, state


@contextlib.contextmanager
def count_collectives():
    """Yields {kind: {"count", "bytes"}} of the collectives run inside."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    state.collectives.append(out)
    try:
        yield out
    finally:
        state.collectives.remove(out)


def total_collective_bytes(coll: Dict[str, Dict[str, float]]) -> int:
    return int(sum(v["bytes"] for v in coll.values()))
