"""Roofline analysis, the reference's ``launch/roofline.py`` on one H100.

Three terms per (arch x shape x mesh) cell, all in seconds, for rank 0:

  compute    = FLOPs          / PEAK_FLOPS
  memory     = bytes accessed / HBM_BW
  collective = collective bytes / LINK_BW

The reference lowers the SPMD program and reads XLA's ``cost_analysis()``
and the HLO text. The port runs rank 0's own program eagerly at its local
shapes on a ``fake`` world of the mesh's size (``launch/mesh.py``), under
``launch/cost.py``'s counter (FLOPs from PyTorch's formula registry and
the kernels' own formulas; bytes: eager, unfused op-by-op traffic, an
upper bound on XLA's fused count) and ``launch/collective_analysis.py``'s
(the output bytes of every all-reduce and all-gather). A cell's ``flops``
and ``bytes_accessed`` are rank 0's, as the reference's are per device.

Depth. The reference corrects for scan bodies that XLA counts once: it
lowers one super-block alone and reports ``full + (ns - 1) * body``. Eager
execution counts every layer, so the port needs no correction; to keep a
cell of 48 layers within one card's memory and a few seconds it counts the
cell cut to 1 and to 2 super-blocks (``cells.materialize_cell(n_super=)``)
and reports ``c1 + (ns - 1) * (c2 - c1)`` for FLOPs, bytes and collective
bytes: the body measured rather than lowered, so the reference's
``_superblock_cell`` has no counterpart here. The rule is exact where a
super-block's work does not depend on the data: dense stacks. An MoE
cell's routed slots depend on the weights and tokens, so its count is the
count of those (seeded) inputs. The reference's encoder-decoder and xLSTM
special cases become an exact count at full depth (``n_super`` ignored for
families without super-blocks).

Hardware: one NVIDIA H100 80GB HBM3 (SXM) at a 700 W power limit, from
NVIDIA's data sheet (dense rates): 989 TFLOP/s bf16 on the tensor cores,
3.35 TB/s of HBM3, and 450 GB/s a direction over NVLink 4 between the
eight cards of one node. A mesh of 256 or 512 ranks spans 32 or 64 such
nodes, whose traffic between nodes crosses the network at a fraction of
that rate, so ``collective_s`` is a lower bound there.
"""
from __future__ import annotations

import dataclasses
from math import prod
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs import ModelConfig, ShapeConfig, get_config, \
    get_shape
from repro_torch.launch.cells import (TRANSFORMER_FAMILIES, build_cell,
                                      cell_is_skipped, materialize_cell)
from repro_torch.launch.collective_analysis import (count_collectives,
                                                    total_collective_bytes)
from repro_torch.launch.cost import count_costs

# NVIDIA H100 80GB HBM3 (SXM), 700.00 W power limit: data sheet peaks
PEAK_FLOPS = 989e12          # bf16 FLOP/s, dense, tensor cores
HBM_BW = 3.35e12             # bytes/s of HBM3
LINK_BW = 450e9              # bytes/s a direction, NVLink 4 (one node)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops: float               # per-device
    bytes_accessed: float
    collective_bytes: float
    n_chips: int
    model_flops: float         # 6*N*D train / 2*N*D serve (global)
    skip: Optional[str] = None

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs * chips): recompute and redundancy waste."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / dominant-term time (the score)."""
        useful_s = self.model_flops / (self.n_chips * PEAK_FLOPS)
        dom = max(self.compute_s, self.memory_s, self.collective_s)
        return useful_s / dom if dom > 0 else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "collective_bytes_per_chip": self.collective_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "skip": self.skip,
        }


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D (train, fwd+bwd) or 2*N*D (serving fwd) with N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: 1 token per row


@dataclasses.dataclass
class Count:
    """One counted run of rank 0's program at ``n_super`` super-blocks
    (None: full depth)."""
    n_super: Optional[int]
    flops: int
    bytes: int
    collective_bytes: int
    collectives: Dict[str, Dict[str, int]]
    kernels: Dict[str, Dict[str, int]]


def count_cell(cell, mesh, *, device, seed: int = 0,
               n_super: Optional[int] = None) -> Count:
    """Rank 0's program of ``cell`` run once on ``mesh`` under the
    counters, its args drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    live = materialize_cell(cell, mesh, generator=g, device=device,
                            n_super=n_super)
    return count_live(live, n_super=n_super)


def count_live(live, *, n_super: Optional[int] = None) -> Count:
    """One counted run of a live cell (``cells.materialize_cell``)."""
    with count_costs() as c, count_collectives() as coll:
        live.fn(*live.args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if c.collective_bytes != total_collective_bytes(coll):
        raise AssertionError("count_live: the two collective counts differ")
    return Count(n_super, c.flops, c.bytes, c.collective_bytes, coll,
                 c.kernels)


def extrapolate(c1, c2, ns: int, a: int = 1, b: int = 2):
    """``c_a + (ns - a) * (c_b - c_a) / (b - a)``: the count at ``ns``
    super-blocks of a stack whose count is affine in its depth."""
    step = (c2 - c1) / (b - a) if (b - a) != 1 else c2 - c1
    return c1 + (ns - a) * step


def depth_counts(cell, mesh, *, device, seed: int = 0,
                 n_super: Optional[Tuple[int, int]] = (1, 2)
                 ) -> Tuple[List[Count], Dict[str, float]]:
    """The counts of ``cell`` (at the two depths of ``n_super``, or one at
    full depth where ``n_super`` is None, the family has no super-blocks,
    or the stack is no deeper) and the totals at full depth."""
    from repro_torch.models.transformer import n_super_blocks
    cfg = cell.cfg
    ns = n_super_blocks(cfg) if cfg.family in TRANSFORMER_FAMILIES else 0
    keys = ("flops", "bytes", "collective_bytes")
    if n_super is None or not ns or ns <= max(n_super):
        c = count_cell(cell, mesh, device=device, seed=seed)
        return [c], {k: float(getattr(c, k)) for k in keys}
    a, b = n_super
    runs = [count_cell(cell, mesh, device=device, seed=seed, n_super=k)
            for k in (a, b)]
    return runs, {k: float(extrapolate(getattr(runs[0], k),
                                       getattr(runs[1], k), ns, a, b))
                  for k in keys}


def roofline_cell(arch: Union[str, ModelConfig],
                  shape_name: Union[str, ShapeConfig], mesh, mesh_name: str,
                  *, device="cuda", policy_overrides=None,
                  n_super: Optional[Tuple[int, int]] = (1, 2),
                  ragged: bool = True, seed: int = 0):
    """(:class:`RooflineTerms`, the counted runs) of one cell, counted on
    ``mesh``: a mesh of ranks (``launch/mesh.py::make_fake_mesh``) whose
    rank 0's program runs on ``device``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    n_chips = prod(mesh.shape.values())
    mf = model_flops_for(cfg, shape)
    skip = cell_is_skipped(cfg, shape)
    if skip:
        return RooflineTerms(cfg.name, shape.name, mesh_name, 0, 0, 0,
                             n_chips, mf, skip=skip), []
    cell = build_cell(cfg, shape, mesh, policy_overrides=policy_overrides,
                      ragged=ragged)
    runs, tot = depth_counts(cell, mesh, device=device, seed=seed,
                             n_super=n_super)
    return RooflineTerms(cfg.name, shape.name, mesh_name, tot["flops"],
                         tot["bytes"], tot["collective_bytes"], n_chips,
                         mf), runs
