"""Unified model API: ``build_model(cfg)`` returns a ``ModelFns`` bundle whose
functions have the same signatures for every ported family, so the serving
engine never branches on architecture.

Every family of the reference: ``dense``, ``moe``, ``vlm`` and ``hybrid``
(``models/transformer.py``), ``ssm`` (``models/xlstm.py``) and ``encdec``
(``models/encdec.py``). ``init`` takes an explicit ``torch.Generator`` and
a device; ``init_cache`` takes the device as a keyword (default ``cuda``);
``loss`` is each family's ``loss_fn``, differentiable by ``torch.autograd``.

The spec helpers (``input_specs``, ``cache_specs``, ``param_specs_abstract``,
``placement_spec``) give the reference's abstract trees as tensors on the
``meta`` device: the shapes and dtypes of one cell's inputs, caches and
params, with no storage and no random draws.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.layers import torch_dtype


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


# ------------------------------------------------------------------ specs
def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of one cell.

    train  -> {"batch": {tokens|embeddings, labels}}
    prefill-> {"batch": {tokens|embeddings(+tokens for encdec), lengths}}
    decode -> {"tokens", "lengths"} (cache specs come from cache_specs()).
    """
    B, S = shape.global_batch, shape.seq_len
    emb = _sds((B, S, cfg.d_model), torch_dtype(cfg.dtype))
    ids = lambda *s: _sds(s, torch.int32)
    if shape.kind in ("train", "prefill"):
        last = {"labels": ids(B, S)} if shape.kind == "train" \
            else {"lengths": ids(B)}
        if cfg.family == "encdec":
            batch = {"embeddings": emb, "tokens": ids(B, S)}
        elif cfg.input_mode == "embeddings":
            batch = {"embeddings": emb}
        else:
            batch = {"tokens": ids(B, S)}
        return {"batch": dict(batch, **last)}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": ids(B), "lengths": ids(B)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Abstract cache tree for decode cells (no allocation)."""
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       device="meta")


def param_specs_abstract(cfg: ModelConfig):
    """The params tree on ``meta``: the init's shapes and dtypes, nothing
    drawn."""
    return build_model(cfg).init(None, device="meta")


def placement_spec(cfg: ModelConfig):
    if not cfg.moe.enabled:
        return None
    return _sds((cfg.n_moe_layers, cfg.moe.n_experts), torch.int32)
