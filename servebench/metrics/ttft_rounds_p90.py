"""90th percentile, over requests due in the window, of the cluster
rounds from the round a request is due to the round of its first token
(to the closing round for one without): scheduling, apart from speed."""
from servebench.stats import quantile


def read(run):
    rec = run.rec
    return quantile([(r.first_round if r.first_round is not None
                      else rec.close_round) - r.due_round
                     for r in run.due_requests()], 0.9)
