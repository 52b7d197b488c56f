"""Mean wall milliseconds of an engine step that had work, in the window
(the traced stretch left out)."""


def read(run):
    steps = [s for s in run.window_steps(untraced=True) if s.worked]
    if not steps:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps)
