"""The ragged expert GEMM's share of its roofline in the traced stretch,
in percent: the least time the card could take for the routed tokens'
three products a layer (gate and up D -> F, down F -> D; the benchmark's
frozen cost formula over each dispatch's expert counts) over the device
time of the ``gmm_ragged`` kernels."""
from servebench import costs, trace
from servebench.stats import traced_steps


def read(run):
    cfg = run.cell.config
    if run.trace is None or not cfg.get("num_experts"):
        return None
    dev_s = trace.kernel_seconds(run.trace, "gmm_ragged")
    if dev_s <= 0:
        return None
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    bound = 0.0
    for s in traced_steps(run):
        for counts in s.expert_counts:          # one dispatch: (L, E)
            for row in counts:
                rows, hit = int(row.sum()), int((row > 0).sum())
                bound += 2 * costs.bound_s(*costs.gmm_ragged_cost(
                    rows, hit, d, f))
                bound += costs.bound_s(*costs.gmm_ragged_cost(rows, hit,
                                                              f, d))
    return 100.0 * bound / dev_s
