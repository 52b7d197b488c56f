"""Weights from the seed, made by the benchmark and handed to both sides.

Every leaf of every layer is drawn from a ``torch.Generator`` of its own,
seeded by (seed, leaf name, layer), on the device that serves it, in one
call: the program's copy and the reference's, which draws a layer again
after the window, get the same values. The leaf table (names, shapes,
kinds, stds by layer) is the architecture's (``arch/<name>_ref.py``
``leaves``), with the published checkpoint's names and orientation
(``x @ W``). Matrices are rounded to bfloat16, the type they are served
in; the router and the norms, which the port keeps in float32, hold
bfloat16-representable values as a checkpoint would. Norm weights are
``1 + std * N(0, 1)``, so that the norms are not identities; matrices are
``N(0, std**2)``, with ``std`` as a rule ``1 / sqrt(fan_in)``.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch

# (shape, kind, std); kind: "matrix" (bf16), "router" (f32 of bf16 values),
# "norm" (f32 of bf16 values around 1), "embed" (bf16, N(0, 1))
LeafSpec = Tuple[Tuple[int, ...], str, float]


def _leaf_seed(seed: int, name: str, layer: int) -> int:
    h = hashlib.sha256(f"{int(seed)}:{name}:{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(seed: int, name: str, layer: int, spec: LeafSpec,
         device) -> torch.Tensor:
    """One leaf of one layer (``layer`` -1 for the model's own leaves), in
    the type the port serves it in: bf16 matrices, f32 norms and router."""
    shape, kind, std = spec
    g = torch.Generator(device=device)
    g.manual_seed(_leaf_seed(seed, name, layer))
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    if kind == "norm":
        return (1.0 + std * x).to(torch.bfloat16).float()
    x = x.mul_(std).to(torch.bfloat16)
    return x.float() if kind == "router" else x
