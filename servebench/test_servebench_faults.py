"""The correctness check fails what it must.

Each test drives a whole run on the CPU at the configurations' smoke
sizes, past the harness's look for a card, and sees ``correct`` come out
false:

* with the timed path broken underneath, once for each fault a serving
  cell can have: a decode step that returns its state (the KV pages)
  unchanged, half of the batch's lanes given the other half's outputs, and
  one token altered where it is produced (the exchange between chips does
  not exist on one card);
* in a MoE cell, with the statistics that feed the coordinator counted
  on the wrong experts (each layer's counts shifted by one expert, B and A
  alike, so that they still agree with each other);
* with the control in the program's place (in
  ``test_servebench_cells.py``, on the cell's sound run).
"""
import json

import pytest

from servebench import harness
from servebench import run as bench_run

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _state_unchanged(orig):
    def decode(params, cfg, tokens, pages, lengths, **kw):
        scratch = {k: {leaf: t.clone() for leaf, t in c.items()}
                   for k, c in pages.items()}
        logits, _, stats = orig(params, cfg, tokens, scratch, lengths, **kw)
        return logits, pages, stats
    return decode


def _half_batch(orig):
    def decode(params, cfg, tokens, pages, lengths, **kw):
        logits, pages, stats = orig(params, cfg, tokens, pages, lengths, **kw)
        n = int(kw["active"].sum())
        h = n // 2
        logits[h:n] = logits[:n - h].clone()
        return logits, pages, stats
    return decode


def _token_altered(orig):
    calls = [0]

    def decode(params, cfg, tokens, pages, lengths, **kw):
        logits, pages, stats = orig(params, cfg, tokens, pages, lengths, **kw)
        n = max(int(kw["active"].sum()), 1)
        i = calls[0] % n
        calls[0] += 1
        top = int(logits[i].argmax())
        logits[i, (top + 1) % logits.shape[-1]] = logits[i].max() + 10.0
        return logits, pages, stats
    return decode


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.models import transformer as tfm
    monkeypatch.setattr(tfm, "decode_step_paged",
                        FAULTS[fault](tfm.decode_step_paged))
    c = harness.load_cell(cell, size="smoke")
    # a fault reads far past the limit: half the window is enough
    _, checks, _ = bench_run.measure(c, 31, 1e9, False, "cpu",
                                   rounds=c.traffic["window_rounds"] // 2)
    assert checks["ok"] is False, checks["checks"]


def _routes(name):
    c = harness.load_cell(name, size="smoke")
    return c.arch.program.moe(c.config) is not None


MOE_CELLS = [c for c in CELLS if _routes(c)]


@pytest.mark.parametrize("cell", MOE_CELLS)
def test_counts_on_the_wrong_experts_are_not_correct(cell, monkeypatch):
    import torch
    from repro_torch.models import moe

    orig = moe._routing_stats

    def shifted(*a, **kw):
        stats = orig(*a, **kw)
        return {k: torch.roll(v, 1, dims=-1) for k, v in stats.items()}

    monkeypatch.setattr(moe, "_routing_stats", shifted)
    c = harness.load_cell(cell, size="smoke")
    _, checks, _ = bench_run.measure(c, 31, 1e9, False, "cpu",
                                   rounds=c.traffic["window_rounds"] // 2)
    assert checks["checks"]["stats_mismatches"]["value"] == 0
    assert checks["checks"]["routed_tokens"]["value"] > 0
    assert checks["ok"] is False, checks["checks"]
