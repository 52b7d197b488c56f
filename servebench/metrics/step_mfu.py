"""Model FLOPs of the window's tokens over the window's wall time at the
card's bf16 peak (989 TFLOP/s), in percent: the whole step's share of the
chip, counted by the cell's architecture's formula (``arch/<name>.py``
``model_flops``) from the published widths, the routed experts and each
token's live context (the traced stretch left out)."""
from servebench import costs
from servebench.stats import round_walls


def read(run):
    walls = round_walls(run)
    if not walls:
        return None
    cfg, model_flops = run.cell.config, run.cell.arch.program.model_flops
    flops = sum(model_flops(cfg, s.prefill_tokens + s.decode_tokens,
                            s.prefill_ctx + s.decode_ctx, s.logits)
                for s in run.rec.steps if s.round in walls)
    return 100.0 * flops / (sum(walls.values()) * costs.PEAK_BF16_FLOPS)
