"""xLSTM model assembly (sLSTM and mLSTM blocks, unrolled).

No KV cache: the "cache" is the list of per-block recurrent states
(``models/ssm.py``), O(1) per request whatever ``max_len``. ``prefill``
starts from the states it is given and returns the new ones; so does
``decode_step``, one token per row. Neither writes the given states in
place, as in the reference. ``loss_fn`` runs the blocks from zero states
over the whole sequence.

Under a policy over several ranks (the reference's entry points leave
the layout to XLA: the weights sharded by ``make_param_specs``, the states
by ``cache_specs_tree`` over the batch) each rank holds its spec's share
and its rows of the batch and of the states. Each block's weights are
gathered whole just before the block (:func:`policy_view`), which then
runs as on one rank on this rank's rows; the embedding and the head are
vocabulary-parallel over ``model`` (``models/layers.py``). A block's
gathered weights are its whole bytes: 15.78 MiB for an mLSTM block and
11.26 MiB for an sLSTM block of xlstm-125m.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (fsdp_plan, gather_leaves,
                                               grad_entry, param_specs)
from repro_torch.models.layers import (embed_tokens, init_embed,
                                       lm_cross_entropy, lm_logits, rms_norm)
from repro_torch.models.ssm import (init_mlstm, init_slstm, mlstm_block,
                                    mlstm_state_init, slstm_block,
                                    slstm_state_init)


def is_slstm(cfg: ModelConfig, i: int) -> bool:
    se = cfg.ssm.slstm_every
    return bool(se) and (i % se == se - 1)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda"):
    """Random params in the reference's layout: ``blocks`` a list of
    ``{"kind_slstm": ...}`` or ``{"kind_mlstm": ...}``, one per block,
    ``block_norms`` a list of f32 norms. The blocks' weights are bf16
    whatever ``cfg.dtype``, as the reference draws them (``init_mlstm`` /
    ``init_slstm`` at their default dtype)."""
    kw = dict(generator=generator, device=device)
    blocks = []
    for i in range(cfg.n_layers):
        if is_slstm(cfg, i):
            blocks.append({"kind_slstm": init_slstm(cfg.d_model, cfg.n_heads,
                                                    **kw)})
        else:
            blocks.append({"kind_mlstm": init_mlstm(cfg.d_model, cfg.n_heads,
                                                    **kw)})
    return {
        "embed": init_embed(cfg, **kw),
        "blocks": blocks,
        "block_norms": [torch.zeros(cfg.d_model, device=device)
                        for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros(cfg.d_model, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               kv_dtype: str = "bfloat16", device="cuda"):
    """The recurrent states, one dict per block (independent of
    ``max_len`` and ``kv_dtype``)."""
    del max_len, kv_dtype
    d_in = 2 * cfg.d_model
    hd_m = d_in // cfg.n_heads
    hd_s = cfg.d_model // cfg.n_heads
    return [slstm_state_init(batch, cfg.n_heads, hd_s, device=device)
            if is_slstm(cfg, i)
            else mlstm_state_init(batch, cfg.n_heads, hd_m, device=device)
            for i in range(cfg.n_layers)]


def policy_view(params, cfg: ModelConfig, policy):
    """Under a policy over several ranks: (the params as the entry points
    read them, each block's gather plan). The embedding's FSDP dimensions
    are gathered here (its vocabulary stays cut over ``model``), each
    block's every cut dimension just before the block; every leaf's
    gradient is summed over the batch axes its spec leaves whole
    (``sharding.grad_entry``). (params, None) otherwise."""
    if policy is None or policy.world_size == 1:
        return params, None
    specs = param_specs(cfg, policy)
    params = grad_entry(params, specs, policy)
    embed = gather_leaves(params["embed"], fsdp_plan(specs, policy)["embed"],
                          policy)
    return dict(params, embed=embed), \
        fsdp_plan(specs["blocks"], policy, everything=True)


def _forward(params, cfg, x, states, plan=None, policy=None):
    new_states = []
    for i in range(cfg.n_layers):
        bp = params["blocks"][i]
        if plan is not None:    # the blocks compute in the promoted type
            bp = gather_leaves(bp, plan[i], policy, promote=x.dtype)
        xn = rms_norm(x, params["block_norms"][i], cfg.norm_eps)
        st = states[i] if states is not None else None
        if "kind_slstm" in bp:
            out, ns = slstm_block(bp["kind_slstm"], xn, cfg.n_heads, state=st,
                                  return_state=True, norm_eps=cfg.norm_eps)
        else:
            out, ns = mlstm_block(bp["kind_mlstm"], xn, cfg.n_heads, state=st,
                                  chunk=cfg.ssm.chunk_size, return_state=True,
                                  norm_eps=cfg.norm_eps)
        new_states.append(ns)
        x = x + out
    return x, new_states


def loss_fn(params, cfg: ModelConfig, batch, *, placement=None,
            policy=None, aux_weight: float = 0.0, ragged: bool = True):
    """batch: {tokens (B, S), labels (B, S), mask optional} -> (loss,
    {"ce", "aux"}): the token cross-entropy; no aux loss (no experts). The
    routing keywords are accepted and unused. Under a train policy each
    rank passes its rows and its shards and gets the global batch's loss
    and its shards' gradients."""
    params, plan = policy_view(params, cfg, policy)
    x = embed_tokens(params["embed"], cfg, batch["tokens"], policy)
    x, _ = _forward(params, cfg, x, None, plan, policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    ce = lm_cross_entropy(params["embed"], cfg, x, batch["labels"],
                          batch.get("mask"), policy)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=x.device)}


def prefill(params, cfg: ModelConfig, batch, cache, *, placement=None,
            source_ids=None, n_sources: int = 0, policy=None,
            collect_stats: bool = True, ragged: bool = True):
    """batch: {tokens (B, S), lengths (B,) optional} -> (logits at each
    row's last real token (B, V), the new states, None). The routing
    keywords are accepted and unused: the model has no experts."""
    params, plan = policy_view(params, cfg, policy)
    x = embed_tokens(params["embed"], cfg, batch["tokens"], policy)
    B, S = x.shape[:2]
    x, states = _forward(params, cfg, x, cache, plan, policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    lengths = batch.get("lengths")
    if lengths is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=x.device),
                 torch.clamp(lengths.long() - 1, 0, S - 1)]
    return lm_logits(params["embed"], cfg, last, policy), states, None


def decode_step(params, cfg: ModelConfig, tokens, cache, lengths, *,
                placement=None, source_ids=None, n_sources: int = 0,
                policy=None, collect_stats: bool = True, ragged: bool = True):
    """tokens (B,) -> (logits (B, V), the new states, None); ``lengths`` is
    accepted and unused (a recurrent state has no positions)."""
    params, plan = policy_view(params, cfg, policy)
    x = embed_tokens(params["embed"], cfg, tokens[:, None], policy)
    x, states = _forward(params, cfg, x, cache, plan, policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params["embed"], cfg, x[:, 0], policy), states, None
