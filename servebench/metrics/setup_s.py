"""Seconds from process start until the window opens: imports, the
kernels' build (cached after a checkout's first run), weights, page pools,
the warm-up serve and the ramp."""


def read(run):
    return run.setup_s
