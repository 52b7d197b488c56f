"""The share of the traced stretch's wall time in which no kernel ran on
the device, in percent (``torch.profiler``, the device alone)."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
