"""Mean milliseconds per traced round in the program's ``coordinator.*``
spans (statistics feed, rebalance, prefetch, weight moves, pressure), a
span inside another coordinator span counted once. None for a cell with
no coordinator."""
from servebench import spans


def read(run):
    found = spans.traced(run)
    if not found:
        return None
    coord = [s for s in found.values() if s.name.startswith("coordinator.")
             and not (s.parent in found
                      and found[s.parent].name.startswith("coordinator."))]
    if not coord:
        return None
    a, b = run.rec.trace_rounds
    return 1e3 * sum(spans.seconds(s) for s in coord) / (b - a)
