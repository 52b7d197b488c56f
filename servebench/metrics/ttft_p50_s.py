"""Median TTFT over every request due in the window (seconds)."""
from servebench.stats import quantile, ttft_s


def read(run):
    return quantile(ttft_s(run), 0.5)
