"""Unified model API: ``build_model(cfg)`` returns a ``ModelFns`` bundle whose
functions have the same signatures for every ported family, so the serving
engine never branches on architecture.

Ported: the decoder-only ``dense`` and ``moe`` families. ``init`` takes an
explicit ``torch.Generator`` and a device; ``init_cache`` takes the device
as a keyword (default ``cuda``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig


class ModelFns(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]           # (generator, device="cuda") -> params
    loss: Callable[..., Any]           # (params, batch, **kw) -> (loss, metrics)
    prefill: Callable[..., Any]        # (params, batch, cache, **kw)
    decode: Callable[..., Any]         # (params, tokens, cache, lengths, **kw)
    init_cache: Callable[..., Any]     # (batch, max_len, **kw) -> cache


def _loss_not_ported(params, batch, **kw):
    raise NotImplementedError("training is not ported yet (ROADMAP.md "
                              "Queue A item 10)")


def build_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  "ported yet (ROADMAP.md Queue A item 9)")
    from repro_torch.models import transformer as m
    return ModelFns(
        cfg=cfg,
        init=lambda generator, device="cuda": m.init_params(
            cfg, generator=generator, device=device),
        loss=_loss_not_ported,
        prefill=lambda params, batch, cache, **kw: m.prefill(
            params, cfg, batch, cache, **kw),
        decode=lambda params, tokens, cache, lengths, **kw: m.decode_step(
            params, cfg, tokens, cache, lengths, **kw),
        init_cache=lambda batch, max_len, **kw: m.init_cache(
            cfg, batch, max_len, **kw),
    )
