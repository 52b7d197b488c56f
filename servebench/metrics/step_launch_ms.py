"""Mean milliseconds per engine step with work, in the traced stretch,
that the host spends in the program's ``model.launch`` spans: enqueueing
the model's kernels and the argmax, up to the readback."""
from servebench import spans


def read(run):
    found = spans.traced(run)
    steps = spans.working_steps(found) if found else []
    if not steps:
        return None
    launch = spans.child_seconds(found, "model.launch")
    return 1e3 * sum(launch.get(i, 0.0) for i, _ in steps) / len(steps)
