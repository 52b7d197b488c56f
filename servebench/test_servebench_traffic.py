"""The traffic copy is a pure function of the seed, and every seed serves
the same sizes and arrivals in the same order."""
import numpy as np
import pytest

from servebench import gen_traffic, harness

MIX = harness.load_cell("qwen3moe_burst_prefill").traffic
V = 151936


def _gen(seed, n=64):
    return gen_traffic.generate(MIX, seed, V, n)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3])
def test_same_seed_same_inputs(seed):
    a, b = _gen(seed), _gen(seed)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.arrival_round) \
            == (y.max_new_tokens, y.arrival_round)
        assert x.prompt.dtype == np.int32
        assert 0 <= x.prompt.min() and x.prompt.max() < V


@pytest.mark.parametrize("mix", ["burst_prefill", "steady_decode"])
def test_seeds_share_sizes_and_arrivals(mix):
    m = harness.load_json(harness.BENCH / "traffic" / f"{mix}.json")
    a, b = (gen_traffic.generate(m, s, V, 64) for s in (11, 2 ** 31 + 11))
    assert [len(r.prompt) for r in a] == [len(r.prompt) for r in b]
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    assert [r.arrival_round for r in a] == [r.arrival_round for r in b]
    assert not np.array_equal(a[0].prompt[:16], b[0].prompt[:16])


def test_a_longer_trace_starts_with_the_shorter_one():
    short, long = _gen(3, 32), _gen(3, 96)
    for x, y in zip(short, long):
        assert np.array_equal(x.prompt, y.prompt)
        assert x.arrival_round == pytest.approx(y.arrival_round)


def test_every_request_fits_its_block_table():
    reqs = _gen(5, 400)
    assert all(len(r.prompt) + r.max_new_tokens <= MIX["max_total_tokens"]
               and r.max_new_tokens >= 1 for r in reqs)
    lens = np.array([len(r.prompt) for r in reqs])
    assert lens.min() >= MIX["prompt"]["min"]
    assert lens.max() <= MIX["prompt"]["max"]
