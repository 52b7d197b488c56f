"""The port's paged entry points against the reference's (attn_backend="xla")
on a float32 twin of the test model: logits and every page but the garbage
page 0 (where duplicate masked writes land in an unspecified order) within
1e-4 after two layers, MoE statistics exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import reduced
from repro.models import build_model
from repro.models import transformer as jtfm
from repro_torch.bridge import config_from_dict, params_from_numpy
from repro_torch.models import transformer as ttfm

TOL = 1e-4
P, PS, NB = 17, 8, 4


@pytest.fixture(scope="module")
def twin():
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    return (cfg, jp, config_from_dict(dataclasses.asdict(cfg)),
            params_from_numpy(jp, device="cpu"))


class Pair:
    """One page pool per package, driven call by call in lockstep."""

    def __init__(self, twin):
        self.jcfg, self.jp, self.tcfg, self.tp = twin
        self.jpages = jtfm.init_paged_cache(self.jcfg, P, PS)
        self.tpages = ttfm.init_paged_cache(self.tcfg, P, PS, device="cpu")

    def prefill(self, tokens, starts, lens, bt, src, decode_mask=None):
        arrs = {"tokens": np.asarray(tokens, np.int32),
                "chunk_starts": np.asarray(starts, np.int32),
                "chunk_lens": np.asarray(lens, np.int32)}
        if decode_mask is not None:
            arrs["decode_mask"] = np.asarray(decode_mask, bool)
        bt = np.asarray(bt, np.int32)
        src = np.asarray(src, np.int32)
        jfn = jtfm.mixed_step_paged if decode_mask is not None \
            else jtfm.prefill_chunk_paged
        tfn = ttfm.mixed_step_paged if decode_mask is not None \
            else ttfm.prefill_chunk_paged
        jl, self.jpages, js = jfn(
            self.jp, self.jcfg, {k: jnp.asarray(v) for k, v in arrs.items()},
            self.jpages, block_tables=jnp.asarray(bt),
            source_ids=jnp.asarray(src), n_sources=2, attn_backend="xla")
        tl, self.tpages, ts = tfn(
            self.tp, self.tcfg, {k: torch.from_numpy(v)
                                 for k, v in arrs.items()},
            self.tpages, block_tables=torch.from_numpy(bt),
            source_ids=torch.from_numpy(src), n_sources=2)
        self.check(tl, jl, ts, js)
        return tl

    def decode(self, tokens, lengths, bt, active, src):
        a = [np.asarray(v, t) for v, t in ((tokens, np.int32),
                                           (lengths, np.int32),
                                           (bt, np.int32), (active, bool),
                                           (src, np.int32))]
        jl, self.jpages, js = jtfm.decode_step_paged(
            self.jp, self.jcfg, jnp.asarray(a[0]), self.jpages,
            jnp.asarray(a[1]), block_tables=jnp.asarray(a[2]),
            active=jnp.asarray(a[3]), source_ids=jnp.asarray(a[4]),
            n_sources=2, attn_backend="xla")
        tl, self.tpages, ts = ttfm.decode_step_paged(
            self.tp, self.tcfg, torch.from_numpy(a[0]), self.tpages,
            torch.from_numpy(a[1]), block_tables=torch.from_numpy(a[2]),
            active=torch.from_numpy(a[3]), source_ids=torch.from_numpy(a[4]),
            n_sources=2)
        self.check(tl, jl, ts, js)
        return tl

    def check(self, tl, jl, ts, js):
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        for k in ("expert_counts", "source_expert"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                          err_msg=k)
        for pos, c in self.tpages.items():
            for leaf, t in c.items():
                np.testing.assert_allclose(
                    t[:, 1:].numpy(), np.asarray(self.jpages[pos][leaf])[:, 1:],
                    rtol=TOL, atol=TOL, err_msg=f"{pos}/{leaf}")


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def _chunk(prompts, starts, lens, S):
    toks = np.zeros((len(prompts), S), np.int32)
    for i, (p, s, n) in enumerate(zip(prompts, starts, lens)):
        toks[i, :n] = p[s:s + n]
    return toks


BT = [[1, 2, 0, 0], [3, 4, 5, 0]]


def _prefill_two(pair):
    """Two requests (13 and 21 tokens) prefilled in two chunks, B=2."""
    prompts = _prompts(pair.jcfg, [13, 21])
    pair.prefill(_chunk(prompts, [0, 0], [8, 8], 8), [0, 0], [8, 8], BT,
                 [0, 1])
    logits = pair.prefill(_chunk(prompts, [8, 8], [5, 13], 16), [8, 8],
                          [5, 13], BT, [0, 1])
    return prompts, logits


def test_chunked_prefill_matches_reference(twin):
    pair = Pair(twin)
    _, logits = _prefill_two(pair)
    assert logits.shape == (2, pair.tcfg.vocab_size)


def test_decode_step_matches_reference(twin):
    pair = Pair(twin)
    prompts, logits = _prefill_two(pair)
    nxt = logits.argmax(-1).tolist()
    bt = BT + [[0, 0, 0, 0]]                     # lane 2 inactive
    for step in range(3):
        logits = pair.decode(nxt + [0], [13 + step, 21 + step, 0], bt,
                             [True, True, False], [0, 1, 0])
        nxt = logits[:2].argmax(-1).tolist()


def test_mixed_step_matches_reference(twin):
    pair = Pair(twin)
    prompts, logits = _prefill_two(pair)
    new = _prompts(pair.jcfg, [10], seed=1)[0]
    # row 0: decode lane of request 0; row 1: first chunk of a new request
    toks = np.zeros((2, 16), np.int32)
    toks[0, 0] = int(logits[0].argmax())
    toks[1, :10] = new
    pair.prefill(toks, [13, 0], [1, 10], [BT[0], [6, 7, 0, 0]], [0, 1],
                 decode_mask=[True, False])
