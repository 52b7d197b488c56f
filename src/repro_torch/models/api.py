"""Unified model API: ``build_model(cfg)`` returns a ``ModelFns`` bundle whose
functions have the same signatures for every ported family, so the serving
engine never branches on architecture.

Every family of the reference: ``dense``, ``moe``, ``vlm`` and ``hybrid``
(``models/transformer.py``), ``ssm`` (``models/xlstm.py``) and ``encdec``
(``models/encdec.py``). ``init`` takes an explicit ``torch.Generator`` and
a device; ``init_cache`` takes the device as a keyword (default ``cuda``);
``loss`` is each family's ``loss_fn``, differentiable by ``torch.autograd``.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig


class ModelFns(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]           # (generator, device="cuda") -> params
    loss: Callable[..., Any]           # (params, batch, **kw) -> (loss, metrics)
    prefill: Callable[..., Any]        # (params, batch, cache, **kw)
    decode: Callable[..., Any]         # (params, tokens, cache, lengths, **kw)
    init_cache: Callable[..., Any]     # (batch, max_len, **kw) -> cache


_FAMILY_MODULES = {"dense": "transformer", "moe": "transformer",
                   "vlm": "transformer", "hybrid": "transformer",
                   "ssm": "xlstm", "encdec": "encdec"}


def build_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family not in _FAMILY_MODULES:
        raise ValueError(f"unknown family {cfg.family!r}")
    m = importlib.import_module(
        f"repro_torch.models.{_FAMILY_MODULES[cfg.family]}")
    return ModelFns(
        cfg=cfg,
        init=lambda generator, device="cuda": m.init_params(
            cfg, generator=generator, device=device),
        loss=lambda params, batch, **kw: m.loss_fn(params, cfg, batch, **kw),
        prefill=lambda params, batch, cache, **kw: m.prefill(
            params, cfg, batch, cache, **kw),
        decode=lambda params, tokens, cache, lengths, **kw: m.decode_step(
            params, cfg, tokens, cache, lengths, **kw),
        init_cache=lambda batch, max_len, **kw: m.init_cache(
            cfg, batch, max_len, **kw),
    )
