"""Shared model layers: norms, rotary embeddings, MLPs, initializers.

Same functions and dtype order as the reference's ``models/layers.py``;
tensors are PyTorch, random draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init utils
# f32 bytes one random draw may take: a leaf above it is drawn in slices of
# its first axis (whole experts of a stacked expert leaf) straight into the
# leaf, so init peaks at the model plus one slice. Every leaf of
# qwen3-moe-30b-a3b fits in one draw, so its weights from a seed are those
# of a whole-leaf draw.
DRAW_BYTES = 2 << 30


def _draw(shape, dtype, device, fill):
    """A leaf of ``dtype`` whose values are ``fill(f32 buffer)`` cast down,
    filled slice by slice along the first axis. On the ``meta`` device
    (abstract params: shapes and dtypes only) nothing is drawn."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    row = 4 * int(np.prod(shape[1:], dtype=np.int64))
    step = max(1, DRAW_BYTES // max(row, 1))
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)     # one slice alive at a time
        out[i:i + n] = fill(torch.empty((n,) + shape[1:],
                                        dtype=torch.float32, device=device))
    return out


def dense_init(shape, in_axis: int = 0, dtype=torch.bfloat16, *,
               generator: torch.Generator, device="cuda"):
    """Truncated-normal fan-in init (what LM stacks actually use)."""
    std = 1.0 / np.sqrt(shape[in_axis])
    return _draw(shape, dtype, device, lambda t: torch.nn.init.trunc_normal_(
        t, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std))


def embed_init(shape, dtype=torch.bfloat16, *, generator: torch.Generator,
               device="cuda"):
    return _draw(shape, dtype, device,
                 lambda t: t.normal_(generator=generator).mul_(0.02))


# ---------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32 accumulation, cast back to input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def softcap(x, cap: float):
    """Logit soft-capping (gemma2): cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------- rotary
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim)).astype(np.float32)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int. Rotates split halves
    (x[..., :hd/2], x[..., hd/2:]), as the reference's code does."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(hd, theta)).to(x.device)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                     # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP
def init_mlp(d_model: int, d_ff: int, dtype=torch.bfloat16, *,
             generator: torch.Generator, device="cuda"):
    kw = dict(generator=generator, device=device)
    return {
        "w_gate": dense_init((d_model, d_ff), 0, dtype, **kw),
        "w_up": dense_init((d_model, d_ff), 0, dtype, **kw),
        "w_down": dense_init((d_ff, d_model), 0, dtype, **kw),
    }


def mlp(params, x, policy=None, d_ff: int = 0):
    """SwiGLU MLP. x: (..., D). silu runs in f32 and is cast back before
    the product with ``up``. Under a policy whose ``model`` axis cuts the
    FFN width ``d_ff`` (column blocks of w_gate and w_up, row blocks of
    w_down on each rank), the ranks' partial products are summed over
    ``model`` in f32, and the input's gradient is summed over ``model``
    (each rank's columns give a part of it)."""
    cut = policy is not None and d_ff and policy.splits(d_ff,
                                                        policy.model_axis)
    xe = policy.enter(x, policy.model_axis) if cut else x
    gate = xe @ params["w_gate"]
    up = xe @ params["w_up"]
    h = F.silu(gate.float()).to(x.dtype) * up
    out = h @ params["w_down"]
    if cut:
        out = policy.all_reduce(out.float(), policy.model_axis).to(x.dtype)
    return out


# ---------------------------------------------------------------- embedding
def init_embed(cfg, *, generator: torch.Generator, device="cuda"):
    dt = torch_dtype(cfg.dtype)
    kw = dict(generator=generator, device=device)
    p = {"embedding": embed_init((cfg.vocab_size, cfg.d_model), dt, **kw)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), 0, dt, **kw)
    return p


def embed_tokens(params, cfg, tokens, policy=None):
    """Under a policy whose ``model`` axis cuts the vocabulary, each rank
    holds a block of the table's rows: it looks up the tokens in its block
    (zeros elsewhere) and the blocks are summed over ``model``, which
    leaves every value exact."""
    table = params["embedding"]
    if policy is not None and policy.splits(cfg.vocab_size,
                                            policy.model_axis):
        M = policy.model_axis
        rows = table.shape[0]
        t = tokens.long() - policy.index(M) * rows
        own = ((t >= 0) & (t < rows))[..., None]
        x = torch.where(own, table[t.clamp(0, rows - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        x = policy.all_reduce(x, M)
    else:
        x = table[tokens.long()]
    if cfg.tie_embeddings:
        # gemma-style sqrt(d) scale, tied-embedding families only
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def lm_logits(params, cfg, x, policy=None):
    """The product runs in the model dtype and is then cast to f32, so the
    logits carry the model dtype's rounding. Under a policy whose ``model``
    axis cuts the vocabulary, each rank computes its block of columns and
    the blocks are gathered: every rank returns the whole (..., V)."""
    cut = policy is not None and policy.splits(cfg.vocab_size,
                                               policy.model_axis)
    if cut:
        x = policy.enter(x, policy.model_axis)
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].T
    else:
        logits = x @ params["lm_head"]
    logits = logits.float()
    if cut:
        logits = policy.all_gather(logits, policy.model_axis, dim=-1)
    return softcap(logits, cfg.final_logit_softcap)


def cross_entropy(logits, labels, mask=None, policy=None):
    """Mean token cross-entropy in f32. logits (..., V), labels (...) int;
    with ``mask`` (...) the mean over the masked tokens (at least 1). Under
    a policy whose batch axes span several ranks, each rank holds its rows:
    the sum and the count are summed over the batch axes before the
    division, so every rank returns the global batch's mean."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return _mean_nll(logz - gold, mask, policy)


def lm_cross_entropy(params, cfg, x, labels, mask=None, policy=None):
    """``cross_entropy(lm_logits(params, cfg, x, policy), labels, mask,
    policy)``. Under a policy whose ``model`` axis cuts the vocabulary it is
    vocabulary-parallel: each rank keeps its block of the logits, and the
    log-sum-exp (from the largest logit, summed ``exp`` terms) and the gold
    logit are summed over ``model``; the whole (..., V) logits, which
    :func:`lm_logits` gathers, are never made (37 GiB at 65536 tokens of
    qwen3's vocabulary)."""
    M = policy.model_axis if policy is not None else None
    if M is None or not policy.splits(cfg.vocab_size, M):
        return cross_entropy(lm_logits(params, cfg, x, policy), labels, mask,
                             policy)
    x = policy.enter(x, M)
    w = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    logits = softcap((x @ w).float(), cfg.final_logit_softcap)
    V = logits.shape[-1]
    top = policy.all_reduce(logits.detach().amax(dim=-1), M, op="max")
    sumexp = policy.all_reduce(
        torch.exp(logits - top[..., None]).sum(dim=-1), M)
    t = labels.long() - policy.index(M) * V
    own = (t >= 0) & (t < V)
    gold = logits.gather(-1, t.clamp(0, V - 1)[..., None])[..., 0]
    gold = policy.all_reduce(torch.where(own, gold, torch.zeros_like(gold)),
                             M)
    return _mean_nll(top + torch.log(sumexp) - gold, mask, policy)


def _mean_nll(nll, mask, policy):
    if policy is not None and policy.size(policy.batch_axes) > 1:
        m = torch.ones_like(nll) if mask is None else mask.to(torch.float32)
        ba = policy.batch_axes
        total = policy.all_reduce(torch.sum(nll * m), ba)
        return total / torch.clamp(policy.all_reduce(torch.sum(m), ba),
                                   min=1.0)
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
