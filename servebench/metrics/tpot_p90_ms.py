"""90th percentile, over requests with two or more tokens in the window,
of each one's mean gap between its tokens there (milliseconds)."""
from servebench.stats import quantile, tpot_s


def read(run):
    q = quantile(tpot_s(run), 0.9)
    return None if q is None else 1e3 * q
