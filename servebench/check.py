"""Whether what the window produced is correct.

Each number against its limit (the configuration file's ``check``
section; ``PERF.md`` gives the readings each was set from):

* the logit gaps: over a sample, drawn from the seed, of the requests the
  window finished, the longest always in it, at every position that
  produced a served token, the float32 reference's best logit less its
  logit of the token the program served (greedy decoding), read as the
  widest (``max_logit_gap``) or the mean (``mean_logit_gap``) gap. They
  cover the paged chunked prefill, paged decode through the pages, the
  router's top k, the expert dispatch and GEMMs, and the LM head.
* ``routing_mismatch_share`` (MoE): every prefill dispatch whose lanes
  all belong to the sampled requests, in the window or its ramp: the
  expert counts B of each routing layer that the dispatch logged for the
  coordinator, held to the counts of the experts the reference's router
  picks at the same prompt positions. The share of the dispatch's routed
  slots (routing layers x tokens x top k) that sit on another expert;
  ``routed_tokens`` says how many prompt tokens it covered.
* ``stats_mismatches``: every (B, A) window statistic the coordinator was
  fed in the window, held to what that step served: each routing layer's
  B sums to top-k times the tokens the engine ran, the engine's own row of
  A equals B, and every other row of A is zero. Exact, so its limit is 0.

The experts, top k and routing layers are the architecture's MoE shape
(``arch/<name>.py`` ``moe``).

``judge(..., control=True)`` puts the control in the program's place: the
reference on fp8 operands (``reference.py``) gives the tokens and the
routing that are judged, on the same requests and dispatches.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from servebench import gen_traffic, reference


def sample(run) -> List[dict]:
    """The requests to compare: the longest finished in the window, then
    others drawn from the seed until the sample holds ``sample_tokens``
    served tokens, ``max_requests`` requests or ``max_ref_tokens`` tokens
    of reference forward."""
    chk = run.cell.config["check"]
    served = run.served
    if not served:
        return []
    ids = sorted(served)
    longest = max(ids, key=lambda i: (len(served[i]["prompt"])
                                      + len(served[i]["output"]), -i))
    rng = np.random.default_rng(gen_traffic._seed_seq(run.seed, 7))
    order = [longest] + [i for i in rng.permutation(ids) if i != longest]
    out, n_served, n_ref = [], 0, 0
    for i in order:
        s = served[int(i)]
        n = len(s["prompt"]) + len(s["output"])
        if out and (n_served >= chk["sample_tokens"]
                    or len(out) >= chk["max_requests"]
                    or n_ref + n > chk["max_ref_tokens"]):
            break
        out.append(s)
        n_served += len(s["output"])
        n_ref += n
    return out


def stats_mismatches(run) -> int:
    """Window statistics that disagree with the steps that made them."""
    moe = run.cell.arch.program.moe(run.cell.config)
    if moe is None:
        return 0
    K = moe.top_k
    tokens: Dict[tuple, int] = {}
    for s in run.rec.steps:
        tokens[(s.round, s.engine)] = s.prefill_tokens + s.decode_tokens
    bad = 0
    for r, e, B, A in run.rec.stats_fed:
        n = tokens.get((r, e), -1)
        B, A = np.asarray(B), np.asarray(A)
        bad += int((B.sum(-1) != K * n).sum())
        bad += int((A[:, e] != B).any(-1).sum())
        others = np.delete(A, e, axis=1)
        bad += int((others != 0).any(-1).any(-1).sum()) if others.size \
            else 0
    return bad


def routing_numbers(run, seqs: List[dict],
                    routing: List[torch.Tensor]) -> Dict[str, float]:
    """The prefill dispatches whose lanes are all sampled requests: the
    share of their routed slots whose expert differs from the one that
    ``routing`` (per sequence: (routing layers, prompt length, top k)
    expert ids) puts there, and how many prompt tokens they routed. Only
    the routing layers count: the dispatch logs a row of B for each, as
    ``routing`` holds one."""
    by_id = {int(s["req_id"]): r for s, r in zip(seqs, routing)}
    moe = run.cell.arch.program.moe(run.cell.config)
    E = moe.experts
    moved = slots = tokens = 0
    for lanes, B in run.rec.prefill_dispatches:
        if not all(rid in by_id for rid, _, _ in lanes):
            continue
        B = np.asarray(B).reshape(len(moe.layers), E).astype(np.int64)
        ref = np.zeros_like(B)
        for rid, start, chunk in lanes:
            ids = by_id[rid][:, start:start + chunk].numpy()
            for layer in range(ids.shape[0]):
                ref[layer] += np.bincount(ids[layer].ravel(), minlength=E)
        moved += int(np.abs(B - ref).sum()) // 2
        slots += int(ref.sum())
        tokens += sum(c for _, _, c in lanes)
    return {"routing_mismatch_share": moved / slots if slots else 0.0,
            "routed_tokens": tokens}


def gap_numbers(gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The readings of one side's per-token gaps: the widest, the mean and
    the 99th percentile."""
    g = torch.cat(gaps).double()
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "p99_logit_gap": float(torch.quantile(g, 0.99))}


def read_numbers(run, device, control: bool = False) -> Dict[str, dict]:
    """Every reading of the sampled requests, by side: ``"served"`` (the
    program's) and, with ``control``, ``"control"`` (the fp8 reference's in
    the program's place): the gap readings, ``compared_tokens`` and, for a
    MoE configuration, ``routing_mismatch_share`` and ``routed_tokens``.
    Empty where the window finished no request."""
    seqs = sample(run)
    if not seqs:
        return {}
    gaps = reference.served_gaps(run.cell.arch.ref, run.cell.config,
                                 run.seed, seqs, device, control=control)
    out = {}
    for side, routing in (("served", "routing"),
                          ("control", "routing_control")):
        if side not in gaps:
            continue
        out[side] = gap_numbers(gaps[side])
        out[side]["compared_tokens"] = sum(len(g) for g in gaps[side])
        if routing in gaps:
            out[side].update(routing_numbers(run, seqs, gaps[routing]))
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def judge(run, device, control: bool = False, numbers=None) -> dict:
    """{"ok", "checks": {name: {"value", "limit"}}} of every number
    compared: the readings that the configuration's ``check.limits``
    names, each at most its limit, and ``stats_mismatches``, at most 0.
    ``compared_tokens`` (at least its limit of 1) says how many served
    tokens the reference judged; a run that judged none is not correct.
    ``routed_tokens`` (at least 0) says how many prompt tokens the routing
    reading covered. With ``control``, the control's tokens and routing are
    judged in the program's place. ``numbers``: ``read_numbers``'s result,
    where it was already read."""
    chk = run.cell.config["check"]
    if numbers is None:
        numbers = read_numbers(run, device, control)
    side = numbers.get("control" if control else "served", {})
    n_tokens = side.get("compared_tokens", 0)
    checks = {name: {"value": side.get(name, float("inf")),
                     "limit": float(limit)}
              for name, limit in chk["limits"].items()}
    checks["stats_mismatches"] = {"value": stats_mismatches(run), "limit": 0}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    checks["compared_tokens"] = {"value": n_tokens, "limit": 1}
    if "routed_tokens" in side:
        checks["routed_tokens"] = {"value": side["routed_tokens"],
                                   "limit": 0}
    return {"ok": ok and n_tokens >= 1, "checks": checks}
