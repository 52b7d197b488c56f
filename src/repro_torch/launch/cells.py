"""Cell builder: (arch x shape x mesh) -> one rank's function, its abstract
args and their specs, the reference's ``launch/cells.py``.

Shared by the dry-run CLI, the roofline and the perf harness. A cell's
``args`` are ``meta`` trees of the global shapes (``models/api.py``'s spec
helpers) and ``specs`` their :class:`PartitionSpec` trees, the reference's
``in_shardings``; nothing is allocated and no process group is needed, so
every cell of the 256- and 512-rank meshes builds on the CPU in a moment.
The rules are the reference's: the same skip reason, the train cell's
state laid out by ``train/train_step.py::train_state_specs`` (int8 moments
and every scale replicated), the decode cell's int8 KV cache where a
rank's bf16 cache would pass 8e9 bytes, the ``(0, 0)`` placement for a
model without experts.

:func:`materialize_cell` gives one rank's local args on a mesh of real (or
``fake``, ``launch/mesh.py::make_fake_mesh``) ranks, drawn from a seeded
``torch.Generator`` straight at the local shapes, so no global tree ever
exists (llama4-maverick's would be 800 GB). Its ``fn`` runs that rank's
program: ``fn(*args)``. ``n_super`` cuts the stack to that many
super-blocks under the full cell's policy, for the roofline's depth
extrapolation (``launch/roofline.py``).
"""
from __future__ import annotations

import dataclasses
from math import prod
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs import ModelConfig, ShapeConfig, get_config, \
    get_shape, get_smoke_config
from repro_torch.distributed.sharding import (P, PartitionSpec, batch_specs,
                                               cache_specs_tree,
                                               make_param_specs, make_policy)
from repro_torch.models import api as model_api
from repro_torch.models.api import build_model
from repro_torch.train import (AdamWConfig, TrainState, init_opt_state,
                               make_train_step, train_state_specs)

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "hybrid")
SMOKE_LEN, SMOKE_BATCH = 64, 32      # a smoke cell's most tokens and rows


class Cell(NamedTuple):
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    policy: Any
    fn: Any                     # one rank's program: fn(*args)
    args: Tuple[Any, ...]       # meta trees (global shapes), or local tensors
    specs: Tuple[Any, ...]      # PartitionSpec trees, one per arg
    skip_reason: Optional[str]
    moment_dtype: str = "bfloat16"
    ragged: bool = True         # the MoE dispatch (``ragged=`` of the models)


def cell_is_skipped(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention stack: 500k-token KV per layer exceeds "
                "the sub-quadratic requirement (DESIGN.md §4)")
    return None


def resolve(arch: str, shape_name: str, smoke: bool = False
            ) -> Tuple[ModelConfig, ShapeConfig]:
    """The config and shape of a cell; ``smoke``: the arch's smoke config
    (same family, tiny widths) at the shape cut to ``SMOKE_LEN`` tokens and
    ``SMOKE_BATCH`` rows, for the CLIs on the CPU."""
    shape = get_shape(shape_name)
    if not smoke:
        return get_config(arch), shape
    return get_smoke_config(arch), dataclasses.replace(
        shape, seq_len=min(shape.seq_len, SMOKE_LEN),
        global_batch=min(shape.global_batch, SMOKE_BATCH))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_cell(arch: Union[str, ModelConfig],
               shape_name: Union[str, ShapeConfig], mesh,
               moment_dtype: str = "bfloat16",
               policy_overrides: Optional[Dict[str, Any]] = None, *,
               ragged: bool = True) -> Cell:
    """The cell of ``arch`` (a name, or a config) at ``shape_name`` (a name,
    or a :class:`ShapeConfig`) on ``mesh``. ``policy_overrides``: fields of
    the policy to replace (``perf_run``'s ``expert_rowparallel``);
    ``ragged``: the MoE dispatch the cell's function runs."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    skip = cell_is_skipped(cfg, shape)
    if skip:
        return Cell(cfg, shape, mesh, None, None, (), (), skip, moment_dtype,
                    ragged)
    mode = "train" if shape.kind == "train" else "serve"
    policy = make_policy(cfg, shape, mesh, mode)
    if policy_overrides:
        policy = dataclasses.replace(policy, **policy_overrides)
    return _build(cfg, shape, policy, moment_dtype, ragged)


def _build(cfg, shape, policy, moment_dtype, ragged) -> Cell:
    mesh = policy.mesh
    fns = build_model(cfg)
    aparams = model_api.param_specs_abstract(cfg)
    pspecs = make_param_specs(aparams, cfg, policy)
    specs = model_api.input_specs(cfg, shape)
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    n_src = prod(mesh.shape[a] for a in data_axes)
    B, S = shape.global_batch, shape.seq_len

    def cell(fn, args, arg_specs):
        return Cell(cfg, shape, mesh, policy, fn, args, arg_specs, None,
                    moment_dtype, ragged)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=moment_dtype)
        astate = TrainState(params=aparams,
                            opt=init_opt_state(aparams, opt_cfg))
        bspecs = batch_specs(cfg, shape, policy, specs["batch"])

        def loss_with_policy(params, batch):
            return fns.loss(params, batch, policy=policy, ragged=ragged)

        step = make_train_step(loss_with_policy, opt_cfg, policy=policy)
        return cell(step, (astate, specs["batch"]),
                    (train_state_specs(policy, opt_cfg), bspecs))

    placement = model_api.placement_spec(cfg)
    if placement is None:
        placement = _meta((0, 0), torch.int32)
    src = _meta((B,), torch.int32)
    sspec = batch_specs(cfg, shape, policy, src)
    stats = cfg.moe.enabled

    if shape.kind == "prefill":
        acache = fns.init_cache(B, S, device="meta")

        def prefill_fn(params, batch, cache, placement_arr, source_ids):
            return fns.prefill(params, batch, cache, placement=placement_arr,
                               source_ids=source_ids, n_sources=n_src,
                               policy=policy, collect_stats=stats,
                               ragged=ragged)

        return cell(prefill_fn,
                    (aparams, specs["batch"], acache, placement, src),
                    (pspecs, batch_specs(cfg, shape, policy,
                                         specs["batch"]),
                     cache_specs_tree(cfg, policy, acache), P(), sspec))

    # decode
    n_chips = prod(mesh.shape.values())
    cache16 = fns.init_cache(B, S, device="meta")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tensors(cache16))
    kv_dtype = "int8" if cache_bytes / n_chips > 8e9 else "bfloat16"
    acache = fns.init_cache(B, S, kv_dtype=kv_dtype, device="meta")
    toks, lens = specs["tokens"], specs["lengths"]

    def decode_fn(params, tokens, cache, lengths, placement_arr, source_ids):
        return fns.decode(params, tokens, cache, lengths,
                          placement=placement_arr, source_ids=source_ids,
                          n_sources=n_src, policy=policy,
                          collect_stats=stats, ragged=ragged)

    tspec = batch_specs(cfg, shape, policy, toks)
    return cell(decode_fn, (aparams, toks, acache, lens, placement, src),
                (pspecs, tspec, cache_specs_tree(cfg, policy, acache), tspec,
                 P(), tspec))


# ------------------------------------------------------------------ trees
def _key(k) -> str:
    return k if isinstance(k, str) else f"[{k}]"


def _walk(fn, tree, specs, path=()):
    """``fn(path, leaf, spec)`` over an arg tree and its spec tree (dicts,
    lists, tuples and NamedTuples); the same structure back."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, specs[k], path + (_key(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(fn, v, getattr(specs, f), path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        out = [_walk(fn, v, s, path + (_key(i),))
               for i, (v, s) in enumerate(zip(tree, specs))]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree, specs)


def tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree (dicts, lists, tuples, NamedTuples)."""
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def cell_leaves(cell: Cell) -> List[Tuple[str, Tuple[int, ...], torch.dtype,
                                          PartitionSpec, int]]:
    """(path, global shape, dtype, spec, this rank's bytes) of every arg
    leaf, paths as ``jax.tree_util`` prints them (``[0]/params/...``)."""
    out = []

    def visit(path, t, spec):
        local = cell.policy.local_shape(tuple(t.shape), spec)
        out.append(("/".join(path), tuple(t.shape), t.dtype, spec,
                    prod(local) * t.element_size()))

    _walk(visit, tuple(cell.args), tuple(cell.specs))
    return out


def argument_bytes(cell: Cell) -> int:
    """The bytes one rank holds of the cell's args under their specs."""
    return sum(r[-1] for r in cell_leaves(cell))


def check_specs(cell: Cell) -> None:
    """Every spec names axes of the mesh and, where it cuts a dimension,
    divides it."""
    for path, shape, _, spec, _ in cell_leaves(cell):
        if len(spec) > len(shape):
            raise ValueError(f"{path}: spec {spec} for shape {shape}")
        for d, s in zip(shape, spec):
            if s is None:
                continue
            axes = (s,) if isinstance(s, str) else tuple(s)
            if any(a not in cell.mesh.shape for a in axes) or \
                    d % cell.policy.size(s):
                raise ValueError(f"{path}: spec {spec} does not divide "
                                 f"{shape} on {cell.mesh}")


# ------------------------------------------------------------------ ranks
def cut_depth(cfg: ModelConfig, n_super: int) -> ModelConfig:
    """``cfg`` with its stack cut to ``n_super`` super-blocks (periods)."""
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(f"cut_depth: the {cfg.family} family has no "
                         "super-blocks to cut")
    from repro_torch.models.transformer import period_descriptors
    return dataclasses.replace(
        cfg, n_layers=n_super * len(period_descriptors(cfg)))


def materialize_cell(cell: Cell, mesh, *, generator: torch.Generator,
                     device, n_super: Optional[int] = None) -> Cell:
    """The cell on ``mesh`` (a mesh of ranks with the cell's axes), its
    ``args`` this rank's local tensors on ``device``: norm scales ones,
    other weights small normals, optimizer state zeros, caches zeros, token
    ids in the vocabulary, every row at full length (a decode row's new
    token at position ``seq_len - 1``: the ring full), the identity
    placement, source ids in ``[0, n_sources)``. ``n_super``: the stack cut
    to that many super-blocks under the full cell's policy."""
    if cell.skip_reason:
        raise ValueError(f"materialize_cell: a skipped cell "
                         f"({cell.skip_reason})")
    if dict(mesh.shape) != dict(cell.mesh.shape):
        raise ValueError(f"materialize_cell: {mesh} is not the cell's "
                         f"{cell.mesh}")
    cfg = cell.cfg if n_super is None else cut_depth(cell.cfg, n_super)
    policy = dataclasses.replace(cell.policy, mesh=mesh, cfg=cfg)
    live = _build(cfg, cell.shape, policy, cell.moment_dtype, cell.ragged)
    shape, kind = cell.shape, cell.shape.kind
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    n_src = prod(mesh.shape[a] for a in data_axes)

    def draw(role):
        def leaf(path, t, spec):
            local = policy.local_shape(tuple(t.shape), spec)
            kw = dict(dtype=t.dtype, device=device)
            name = path[-1] if path else ""
            if role in ("opt", "cache"):
                return torch.zeros(local, **kw)
            if role == "params":
                if any("norm" in k for k in path):
                    return torch.ones(local, **kw)
                return (torch.randn(local, generator=generator,
                                    device=device) * 0.02).to(t.dtype)
            if name in ("tokens", "labels") or role == "tokens":
                return torch.randint(0, cfg.vocab_size, local,
                                     generator=generator, **kw)
            if name == "embeddings":
                return torch.randn(local, generator=generator,
                                   device=device).to(t.dtype)
            if name == "lengths" or role == "lengths":
                full = shape.seq_len - (kind == "decode")
                return torch.full(local, full, **kw)
            if role == "placement":
                from repro_torch.models.transformer import \
                    identity_placement
                return identity_placement(cfg, device) if t.numel() \
                    else torch.zeros(local, **kw)
            if role == "sources":
                return torch.randint(0, n_src, local, generator=generator,
                                     **kw)
            raise ValueError(f"materialize_cell: no rule for {path}")
        return leaf

    a, s = live.args, live.specs
    if kind == "train":
        state = TrainState(params=_walk(draw("params"), a[0].params,
                                        s[0].params),
                           opt=_walk(draw("opt"), a[0].opt, s[0].opt))
        args = (state, _walk(draw("batch"), a[1], s[1]))
    elif kind == "prefill":
        args = (_walk(draw("params"), a[0], s[0]),
                _walk(draw("batch"), a[1], s[1]),
                _walk(draw("cache"), a[2], s[2]),
                _walk(draw("placement"), a[3], s[3]),
                _walk(draw("sources"), a[4], s[4]))
    else:
        args = (_walk(draw("params"), a[0], s[0]),
                _walk(draw("tokens"), a[1], s[1]),
                _walk(draw("cache"), a[2], s[2]),
                _walk(draw("lengths"), a[3], s[3]),
                _walk(draw("placement"), a[4], s[4]),
                _walk(draw("sources"), a[5], s[5]))
    return live._replace(args=args)


def resident_bytes(args) -> int:
    """The bytes of a tree of tensors."""
    return sum(t.numel() * t.element_size() for t in tensors(args))
