"""Train step: loss -> grads -> (optional int8 gradient compression) ->
AdamW, the reference's ``train/train_step.py``.

Grads are taken the PyTorch way, as ``jax.value_and_grad`` takes them:
the step differentiates with respect to ``detach().requires_grad_()``
views of the param leaves (``torch.autograd.grad``), so
``TrainState.params`` never require grad and the serving engines, which
write params in place when experts migrate, can take trained params as
they are. The reference's sharding ``policy`` waits for the port's
multi-device work (ROADMAP.md Queue A item 11).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.bridge import tree_flatten, tree_map, tree_unflatten
from repro_torch.train.optimizer import (AdamWConfig, OptState, apply_updates,
                                         init_opt_state)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def make_train_state(params, opt_cfg: AdamWConfig) -> TrainState:
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg))


def compress_grads_int8(grads):
    """Simulated-quantization gradient compression for the DP all-reduce:
    per-tensor symmetric int8 fake quantization, returned in f32 (the
    values an int8 all-reduce would carry, times their f32 scale)."""
    def q(g):
        scale = g.abs().amax().float() / 127.0
        qi = torch.round(g.float() / torch.clamp(scale, min=1e-12))
        return torch.clamp(qi, -127, 127).to(torch.int8).float() * scale

    return tree_map(q, grads)


def make_train_step(loss_fn, opt_cfg: AdamWConfig, *,
                    grad_compression: Optional[str] = None):
    """loss_fn(params, batch) -> (loss, metrics). Returns
    ``train_step(state, batch) -> (new state, metrics + {"loss"})``; the
    given state is left as it is."""

    def train_step(state: TrainState, batch):
        leaves = tree_flatten(state.params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_fn(tree_unflatten(state.params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        # a leaf the loss never reads gets a zero gradient, as in JAX
        grads = tree_unflatten(state.params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        del live
        if grad_compression == "int8":
            grads = compress_grads_int8(grads)
        params, opt = apply_updates(state.params, grads, state.opt, opt_cfg)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return TrainState(params, opt), metrics

    return train_step
