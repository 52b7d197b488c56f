"""Train step: loss -> grads -> (optional int8 gradient compression) ->
AdamW, the reference's ``train/train_step.py``.

Grads are taken the PyTorch way, as ``jax.value_and_grad`` takes them:
the step differentiates with respect to ``detach().requires_grad_()``
views of the param leaves (``torch.autograd.grad``), so
``TrainState.params`` never require grad and the serving engines, which
write params in place when experts migrate, can take trained params as
they are.

Under a policy over several ranks (``make_train_step(policy=)``) each rank holds its blocks of the params and moments and passes its rows
of the batch; ``loss_fn`` (a family's ``loss`` under the same policy)
returns the global loss and this rank's blocks of the global grads, the
optimizer clips by the global norm across the shards and updates each
block (``train/optimizer.py``), and int8 gradient compression scales each
tensor by its global ``max|g|``. The reference reads each leaf's layout
from its array; a rank's block carries none, so the port reads it from
the spec tree of the config the policy was made for
(``sharding.param_specs``), as the models do.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.bridge import tree_flatten, tree_map, tree_unflatten
from repro_torch.distributed.sharding import (P, leaf_specs, param_specs,
                                               spec_axes)
from repro_torch.train.optimizer import (AdamWConfig, OptState, apply_updates,
                                         init_opt_state)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def make_train_state(params, opt_cfg: AdamWConfig, *,
                     policy=None) -> TrainState:
    return TrainState(params=params, opt=init_opt_state(
        params, opt_cfg, policy=policy))


def train_state_specs(policy, opt_cfg: AdamWConfig) -> TrainState:
    """The spec tree of a :class:`TrainState` under ``policy`` (its params'
    specs, ``sharding.param_specs``), as the reference's train cell
    (``launch/cells.py``) lays it out: moments cut like their params, int8
    moments and every scale and the step replicated."""
    specs = param_specs(None, policy)
    rep = tree_map(lambda s: P(), specs)
    mom = rep if opt_cfg.moment_dtype == "int8" else specs
    return TrainState(params=specs, opt=OptState(
        step=P(), mu=mom, nu=mom, mu_scale=rep, nu_scale=rep))


def compress_grads_int8(grads, policy=None):
    """Simulated-quantization gradient compression for the DP all-reduce:
    per-tensor symmetric int8 fake quantization, returned in f32 (the
    values an int8 all-reduce would carry, times their f32 scale). Under a
    policy over several ranks a tensor's scale is its global ``max|g|``
    (the largest over the axes its spec cuts)."""
    leaves = tree_flatten(grads)
    s_leaves = leaf_specs(policy) or [None] * len(leaves)

    def q(g, spec):
        top = g.abs().amax().float()
        if spec is not None:
            top = policy.all_reduce(top, spec_axes(spec, policy), op="max")
        scale = top / 127.0
        qi = torch.round(g.float() / torch.clamp(scale, min=1e-12))
        return torch.clamp(qi, -127, 127).to(torch.int8).float() * scale

    return tree_unflatten(grads, [q(g, s) for g, s in zip(leaves,
                                                           s_leaves)])


def make_train_step(loss_fn, opt_cfg: AdamWConfig, *, policy=None,
                    grad_compression: Optional[str] = None):
    """loss_fn(params, batch) -> (loss, metrics). Returns
    ``train_step(state, batch) -> (new state, metrics + {"loss"})``; the
    given state is left as it is. ``policy``: the train policy ``loss_fn``
    runs under (None: the one-process step)."""

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
            grads = compress_grads_int8(grads, policy)
        params, opt = apply_updates(state.params, grads, state.opt, opt_cfg,
                                    policy=policy)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return TrainState(params, opt), metrics

    return train_step
