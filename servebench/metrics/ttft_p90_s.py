"""90th percentile of TTFT over every request due in the window
(seconds): the highest percentile with ten samples beyond it at some 150
requests due."""
from servebench.stats import quantile, ttft_s


def read(run):
    return quantile(ttft_s(run), 0.9)
