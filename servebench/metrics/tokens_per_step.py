"""Prefill and decode tokens per engine step with work in the window, from
the engines' own counters."""


def read(run):
    a, b = run.rec.counters_open, run.rec.counters_close
    steps = sum(b[e][0] - a[e][0] for e in b)
    toks = sum(b[e][1] - a[e][1] + b[e][2] - a[e][2] for e in b)
    return toks / steps if steps else None
