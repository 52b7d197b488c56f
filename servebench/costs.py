"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the two kernels whose roofline share the benchmark
reports.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* :func:`gmm_ragged_cost` from ``repro_torch/kernels/moe_gmm.py::
  moe_gmm_ragged_cost``, with the rows the inputs need (the routed
  tokens' slots) in place of the padded rows the kernel's layout takes:
  a roofline counts what these inputs need, not what an implementation
  chose to pad;
* :func:`paged_decode_cost` from ``repro_torch/kernels/paged_decode.py::
  paged_decode_cost``, over the live lanes only, with the block-table
  entries those lanes use;
* the model FLOPs of a step are each architecture's own formula
  (``arch/<name>.py`` ``model_flops``): the config's published widths,
  the routed experts of each token and attention over each token's live
  context, whatever implements the model.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for bf16 work: the larger of
    the compute and the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def gmm_ragged_cost(rows: int, hit: int, D: int, F: int, item: int = 2):
    """(FLOPs, bytes) of one ragged grouped product over ``rows`` routed
    slots of ``hit`` experts: the rows and those experts' (D, F) weights
    read in their type, the (rows, F) f32 output written."""
    return 2 * rows * D * F, rows * D * item + hit * D * F * item \
        + rows * F * 4


def paged_decode_cost(lanes: int, live: int, blocks: int, Hq: int, Hkv: int,
                      hd: int, item: int = 2):
    """(FLOPs, bytes) of one paged decode call over ``lanes`` live lanes
    holding ``live`` context tokens in ``blocks`` pages: q read and the
    output written in their type, K and V of the live tokens, the block
    table entries and the lengths."""
    nbytes = 2 * lanes * Hq * hd * item + live * Hkv * 2 * hd * item \
        + blocks * 4 + lanes * 4
    return 4 * live * Hq * hd, nbytes


def ctx_sum(start: int, n: int) -> int:
    """Sum of the live contexts of positions start .. start + n - 1, each
    attending to itself and every earlier position."""
    end = start + n
    return end * (end + 1) // 2 - start * (start + 1) // 2
