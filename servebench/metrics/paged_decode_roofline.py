"""The paged decode kernel's share of its roofline in the traced stretch,
in percent: the least time the card could take for each decode call's
live lanes and context (the benchmark's frozen cost formula, one call a
layer) over the device time of the decode kernels and their combine
pass."""
from servebench import costs, trace
from servebench.stats import traced_steps


def read(run):
    if run.trace is None:
        return None
    dev_s = trace.kernel_seconds(run.trace, "paged_decode",
                                 "split_kv::combine")
    if dev_s <= 0:
        return None
    cfg = run.cell.config
    bound = sum(cfg["num_hidden_layers"] * costs.bound_s(
        *costs.paged_decode_cost(
            s.decode_tokens, s.decode_ctx, s.decode_blocks,
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"]))
        for s in traced_steps(run) if s.decode_tokens)
    return 100.0 * bound / dev_s
