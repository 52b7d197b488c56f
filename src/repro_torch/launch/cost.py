"""What one rank's program costs: the port's counterpart of XLA's
``compiled.cost_analysis()`` in the reference's ``launch/roofline.py``.

``count_costs()`` is a ``TorchDispatchMode`` over the aten ops one rank
runs, eagerly, at its local shapes (``launch/cells.py``). It sums:

* **FLOPs** from ``torch.utils.flop_counter``'s formula registry, which
  covers the matrix products, convolutions and fused attention. Elementwise
  operations count no FLOPs here; XLA's count includes them, so an
  elementwise-heavy program reads lower than the reference's would.
* **Bytes**: the bytes of every non-view aten op's tensor inputs and
  outputs, each read and each write once. This is eager PyTorch's own HBM
  traffic, one op at a time with nothing fused, so it is an upper bound on
  what XLA's fused "bytes accessed" would give for the same program.
  Copies between the host and the device (``.tolist()``, ``.item()``) are
  not device memory traffic and count nowhere.
* **Collective bytes**: what ``distributed/sharding.py``'s collectives put
  out (``launch/collective_analysis.py``); the ops inside a collective are
  not counted as memory bytes.

Each hand-written kernel counts itself. Its wrapper runs inside a region
of its own (``counting.counted``, a module the kernels and the policy
import, below this one), on the CUDA route and the plain route alike:
the counter adds the kernel's own formula (the module's ``*_cost``
function, which ``chip_smoke.py``'s bound column reads too) and
counts no op inside the region. So a cell counts the same work whether the
kernel or its plain version ran: without this the CPU would count the plain
versions' step-by-step arithmetic, and the card nothing at all for a ctypes
launch. Regions nest; only the outermost counts. With no counter active a
region costs one check of a module-level flag, so the serving path pays
nothing for it.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.counting import Costs, state

# ---------------------------------------------------------------- the mode
# ops that move no device data: metadata only, storage left unwritten, or
# a read of one element to the host
_NO_TRAFFIC = frozenset(("_unsafe_view", "empty", "empty_strided",
                         "empty_like", "new_empty", "new_empty_strided",
                         "resize_", "set_", "lift_fresh",
                         "_local_scalar_dense"))
_COPIES = frozenset(("_to_copy", "copy_"))


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _traffic(func, args, kwargs, out) -> int:
    """The bytes an op reads and writes on the device; 0 for a copy
    between the host and the device."""
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if func._overloadpacket.__name__ in _COPIES and \
            {t.device for t in ins} != {t.device for t in outs}:
        return 0
    return sum(t.numel() * t.element_size() for t in ins + outs)


def _mode(costs: Costs):
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class CostMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if state.depth:
                return out
            packet = func._overloadpacket
            costs.ops += 1
            if packet in flop_registry:
                costs.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if packet.__name__ not in _NO_TRAFFIC and not _is_view(func):
                costs.bytes += _traffic(func, args, kwargs, out)
            return out

    return CostMode()


@contextlib.contextmanager
def count_costs():
    """Yields the :class:`Costs` of what runs inside, forward and backward.
    One at a time: a second one inside raises."""
    if state.counter is not None:
        raise RuntimeError("count_costs: a count is already open")
    costs = Costs()
    state.counter, state.depth = costs, 0
    try:
        with _mode(costs):
            yield costs
    finally:
        state.counter, state.depth = None, 0
