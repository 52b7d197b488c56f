"""The expert GEMMs' route choice (``kernels/moe_gmm.tc_eligible``): bf16 at
widths that are multiples of 8 (and a depth above 0) with 16-byte aligned
pointers takes the tensor cores; f32, odd widths and unaligned pointers
take the CUDA cores.
The choice is a pure function of dtype, widths and pointers, so it is
checked here on the CPU; the launches themselves run in
``tests/test_torch_cuda_kernels.py`` on the card."""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import (TC_CODE, _route_code, moe_gmm,
                                         moe_gmm_ragged, tc_eligible)

ALIGNED = (0x7f0000000000, 0x7f0000100000, 0x7f0000200010)


@pytest.mark.parametrize("D,F", [(2048, 768), (768, 2048), (8, 8),
                                 (256, 96), (72, 136)])
def test_tc_eligible_accepts_bf16_multiples_of_8(D, F):
    assert tc_eligible(torch.bfloat16, D, F, *ALIGNED)


@pytest.mark.parametrize("D,F", [(2048, 768), (768, 2048)])
def test_tc_eligible_refuses_f32(D, F):
    assert not tc_eligible(torch.float32, D, F, *ALIGNED)


@pytest.mark.parametrize("D,F", [(2047, 768), (2048, 770), (100, 130),
                                 (37, 131), (4, 8), (0, 768)])
def test_tc_eligible_refuses_widths_not_multiples_of_8(D, F):
    """(D = 0, an empty depth, stays on the CUDA cores too: its output is
    zeros and a TMA descriptor needs a positive extent.)"""
    assert not tc_eligible(torch.bfloat16, D, F, *ALIGNED)


@pytest.mark.parametrize("bad", [0, 1, 2])
@pytest.mark.parametrize("offset", [2, 8])
def test_tc_eligible_refuses_unaligned_pointers(bad, offset):
    ptrs = list(ALIGNED)
    ptrs[bad] += offset
    assert not tc_eligible(torch.bfloat16, 2048, 768, *ptrs)


def test_route_code_from_tensors():
    """The code the wrappers pass to the entry points: 2 for the tensor
    cores, else the dtype's own code (CUDA cores)."""
    out = torch.empty(4, 768)
    w = torch.zeros(2, 2048, 768, dtype=torch.bfloat16)
    x = torch.zeros(8, 2048, dtype=torch.bfloat16)
    assert _route_code(x, w, out) == TC_CODE
    assert _route_code(x.float(), w.float(), out) == \
        ops.DTYPE_CODE[torch.float32]
    # a contiguous view 2 bytes past a 16-byte boundary
    xu = torch.zeros(8 * 2048 + 1, dtype=torch.bfloat16)[1:].view(8, 2048)
    assert xu.is_contiguous() and xu.data_ptr() % 16
    assert _route_code(xu, w, out) == ops.DTYPE_CODE[torch.bfloat16]


def test_cpu_wrappers_count_no_launch():
    """On a CPU tensor the wrappers run the plain versions: no launch, on
    either route."""
    counts = (moe_gmm.launches, moe_gmm.tc_launches,
              moe_gmm_ragged.launches, moe_gmm_ragged.tc_launches)
    x = torch.randn(2, 3, 16).bfloat16()
    w = torch.randn(2, 16, 8).bfloat16()
    moe_gmm(x, w)
    meta = (torch.zeros(2, dtype=torch.int32),
            torch.tensor([3, 0], dtype=torch.int32),
            torch.tensor([0, 8, 8], dtype=torch.int32))
    moe_gmm_ragged(torch.randn(16, 16).bfloat16(), w, *meta, n_block=8)
    assert (moe_gmm.launches, moe_gmm.tc_launches, moe_gmm_ragged.launches,
            moe_gmm_ragged.tc_launches) == counts
