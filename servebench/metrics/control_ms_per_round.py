"""Mean wall milliseconds a window round spends outside its engines'
steps: dispatch, traces, the coordinator, migrations (the traced stretch
left out)."""
from servebench.stats import round_walls


def read(run):
    walls = round_walls(run)
    if not walls:
        return None
    in_steps = sum(s.t1 - s.t0 for s in run.rec.steps if s.round in walls)
    return 1e3 * (sum(walls.values()) - in_steps) / len(walls)
