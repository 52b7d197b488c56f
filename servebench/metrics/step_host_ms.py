"""Mean host milliseconds of an engine step that had work, in the traced
stretch: the program's ``engine.step`` span less its ``engine.wait``
children, in which the host waits for the device's results.

While the model's launch itself synchronises with the device (each
layer's rotary table copy and the MoE layer's ``bincount`` did when this
metric was written), the host waits inside ``model.launch`` too, so this
reads device-paced time close to ``step_launch_ms``; it reads the host's
own part of a step once the launch no longer synchronises."""
from servebench import spans


def read(run):
    found = spans.traced(run)
    steps = spans.working_steps(found) if found else []
    if not steps:
        return None
    waits = spans.child_seconds(found, "engine.wait")
    return 1e3 * sum(spans.seconds(s) - waits.get(i, 0.0)
                     for i, s in steps) / len(steps)
