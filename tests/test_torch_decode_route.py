"""The decode kernels' route choice and context slices
(``kernels/decode_route.py``): bf16 with hd a multiple of 16 up to 128, at
most 16 query heads per KV head and 16-byte aligned pointers takes the
tensor cores; f32, other widths, more heads and unaligned pointers take
the CUDA cores. The slice each block of the partial pass covers has one
length whatever the batch, the block table or the cache length, so a
request's output bits do not depend on its neighbours.
Both are pure functions of shapes and pointers, so they are checked here on
the CPU; the launches themselves run in ``tests/test_torch_cuda_kernels.py``
on the card. So is the yardstick the decode outputs are held to there and
in ``chip_smoke.py`` (``row_rel_err``): it must pass a bf16 rounding and
fail a kernel that skips one slice of a 32768-token context."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_route import (ROW_TOL, SPLIT_TOKENS,
                                              TC_CODE, route_code,
                                              row_rel_err, scratch,
                                              split_plan, tc_eligible)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.paged_decode import paged_decode

ALIGNED = (0x7f0000000000, 0x7f0000100000, 0x7f0000200010)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_tc_eligible_accepts_bf16_serving_widths(hd, G):
    assert tc_eligible(torch.bfloat16, hd, G, *ALIGNED)


@pytest.mark.parametrize("hd", [16, 48, 112])
def test_tc_eligible_accepts_other_multiples_of_16(hd):
    assert tc_eligible(torch.bfloat16, hd, 16, *ALIGNED)


@pytest.mark.parametrize("hd,G", [(128, 8), (64, 4)])
def test_tc_eligible_refuses_f32(hd, G):
    assert not tc_eligible(torch.float32, hd, G, *ALIGNED)


@pytest.mark.parametrize("hd", [8, 24, 40, 72, 100, 136, 256])
def test_tc_eligible_refuses_other_head_widths(hd):
    """Not a multiple of 16, or wider than 128 (hd = 256 keeps the CUDA
    cores: its fragments and accumulator would not fit the registers)."""
    assert not tc_eligible(torch.bfloat16, hd, 8, *ALIGNED)


@pytest.mark.parametrize("G", [0, 17, 32])
def test_tc_eligible_refuses_head_groups_past_16(G):
    assert not tc_eligible(torch.bfloat16, 128, G, *ALIGNED)


@pytest.mark.parametrize("bad", [0, 1, 2])
@pytest.mark.parametrize("offset", [2, 8])
def test_tc_eligible_refuses_unaligned_pointers(bad, offset):
    ptrs = list(ALIGNED)
    ptrs[bad] += offset
    assert not tc_eligible(torch.bfloat16, 128, 8, *ptrs)


def test_route_code():
    """The code the wrappers pass to the entry points: 2 for the tensor
    cores, else the dtype's own code (CUDA cores)."""
    assert route_code(torch.bfloat16, 128, 8, *ALIGNED) == TC_CODE
    assert route_code(torch.float32, 128, 8, *ALIGNED) == \
        ops.DTYPE_CODE[torch.float32]
    assert route_code(torch.bfloat16, 256, 8, *ALIGNED) == \
        ops.DTYPE_CODE[torch.bfloat16]
    assert TC_CODE not in ops.DTYPE_CODE.values()


@pytest.mark.parametrize("n_tokens", [0, 1, 127, 128, 129, 1024, 32768,
                                      32769, 1 << 20])
def test_split_plan_covers_the_context(n_tokens):
    """The slice length is the constant SPLIT_TOKENS whatever the context
    the wrappers pass (NB * ps for the pages, L for the dense cache), so it
    does not change with the batch, the block table or the cache length."""
    split, n_split = split_plan(n_tokens)
    assert split == SPLIT_TOKENS and split % 32 == 0
    assert n_split >= 1 and n_split * split >= n_tokens
    assert (n_split - 1) * split < max(n_tokens, 1)


@pytest.fixture(scope="module")
def long_context():
    """Two requests at a 32768-slot ring (one full, one at 20000 tokens) at
    the serving head width, bf16 inputs from a seed, and the plain output
    in f32."""
    g = torch.Generator().manual_seed(0)
    B, Hq, hd, L = 2, 8, 128, 32768
    q = torch.randn(B, Hq, hd, generator=g).bfloat16()
    kc = torch.randn(B, L, 1, hd, generator=g).bfloat16()
    vc = torch.randn(B, L, 1, hd, generator=g).bfloat16()
    k_pos = torch.arange(L, dtype=torch.int32).repeat(B, 1)
    q_pos = torch.tensor([L - 1, 19999], dtype=torch.int32)
    args = (q.float(), kc.float(), vc.float())
    return q, kc, vc, k_pos, q_pos, flash_decode_plain(*args, k_pos, q_pos)


def test_row_rel_err_accepts_bf16_rounding(long_context):
    """The plain version in bf16 (its output rounded once) stays well inside
    the bar against the f32 one at a 32768-token context."""
    q, kc, vc, k_pos, q_pos, ref = long_context
    out = flash_decode_plain(q, kc, vc, k_pos, q_pos)
    assert row_rel_err(out, ref) < ROW_TOL[torch.bfloat16] / 3


@pytest.mark.parametrize("drop", [
    slice(0, SPLIT_TOKENS),                       # the first slice
    slice(16384, 16384 + SPLIT_TOKENS),           # one slice mid-context
    slice(32768 - SPLIT_TOKENS, 32768),           # the last slice
    slice(0, 3277)])                              # a tenth of the context
def test_row_rel_err_rejects_a_planted_fault(long_context, drop):
    """A kernel that skips one slice (a block, or a slice in the combine)
    or a tenth of a 32768-token context fails the bar, although its largest
    absolute error stays under the 3e-2 bar of the bf16 outputs."""
    q, kc, vc, k_pos, q_pos, ref = long_context
    k_pos = k_pos.clone()
    k_pos[:, drop] = -1
    faulty = flash_decode_plain(q.float(), kc.float(), vc.float(), k_pos,
                                q_pos)
    assert float((faulty - ref).abs().max()) < 3e-2
    assert row_rel_err(faulty, ref) > 4 * ROW_TOL[torch.bfloat16]


def test_row_rel_err_exact_zero_rows():
    ref = torch.zeros(2, 4, 8)
    ref[1] = 1.0
    out = ref.clone()
    assert row_rel_err(out, ref) == 0.0
    out[1, 0, 0] = 1.5
    assert row_rel_err(out, ref) == pytest.approx(0.5 / np.sqrt(32))
    out[0, 2, 3] = 1e-6                  # a ctx = 0 row that is not zero
    assert row_rel_err(out, ref) == float("inf")


def test_scratch_holds_every_partial():
    buf = scratch(3, 8, 5, 64, torch.device("cpu"))
    assert buf.dtype == torch.float32
    assert buf.numel() == 3 * 8 * 5 * (64 + 2)


def test_cpu_wrappers_count_no_launch():
    """On a CPU tensor the wrappers run the plain versions: no launch, on
    either route."""
    counts = (paged_decode.launches, paged_decode.tc_launches,
              flash_decode.launches, flash_decode.tc_launches)
    q = torch.randn(2, 8, 64).bfloat16()
    kp = torch.randn(5, 8, 2, 64).bfloat16()
    bt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    out = paged_decode(q, kp, kp, bt, torch.tensor([12, 3],
                                                   dtype=torch.int32))
    assert out.shape == q.shape
    kc = torch.randn(2, 16, 2, 64).bfloat16()
    k_pos = torch.arange(16, dtype=torch.int32).repeat(2, 1)
    out = flash_decode(q, kc, kc, k_pos, torch.tensor([5, 15],
                                                      dtype=torch.int32))
    assert out.shape == q.shape
    assert (paged_decode.launches, paged_decode.tc_launches,
            flash_decode.launches, flash_decode.tc_launches) == counts
