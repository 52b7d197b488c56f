"""Device and event time of the int8 KV write and of the MoE statistics,
kernel by kernel and as their call sites issue them: the sequences the
port issued before the fused write and the unsorted statistics call,
rebuilt here, beside the calls the port makes now.

    python3 experiments/bench_torch/callsite_ab.py [--out FILE]

It uses ``chip_smoke.Timer`` (CUDA events with L2 flushed; device time
from torch.profiler) and times, at full width (4 KV heads of 128, 128
experts, top-8, bf16):

- ``pack_kv`` alone at a decode step's K (8, 1, 4, 128);
- the int8 KV write of one layer: as the port issued it before (the page
  slots in index ops, ``pack_kv`` on K and on V, four index-puts), and
  through ``pack_kv_into_pages``, at a decode step (B=8, one lane idle)
  and a 512-token prefill chunk;
- ``source_expert_count`` alone at T=8, K=8 and T=2048, K=1;
- the statistics call site of ``_ragged_moe_ffn``: as before, the ids
  gathered into the dispatch's sort order and counted by the memsets and
  the grid (the only path the kernel had then), and as now, the router's
  ids as they come, at a decode step (T=8, one token masked) and a
  512-token chunk (12 masked);
- the unchanged kernels' rows of ``chip_smoke.py`` at their serving
  shapes: the ragged and padded expert GEMMs and ``unpack_kv``.

Each item reports event ms, device ms and device operations (kernels and
memsets) per call. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def device_ops(timer, fn):
    """(device ms, device operations, {operation: launches}) per call of
    ``fn`` under torch.profiler, the flush (a bitwise_not) left out. As in
    ``chip_smoke.Timer.device``, an operation's time per call is its mean
    over the events seen times its launches per call, which tolerates an
    event the profiler drops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(timer.warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):            # a profile now and then sees nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(timer.iters):
                timer.flush_buf.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        ms, ops = 0.0, {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or "bitwise_not" in e.key:
                continue
            n = max(1, round(e.count / timer.iters))
            ms += e.self_device_time_total / 1e3 / e.count * n
            ops[e.key[:70]] = ops.get(e.key[:70], 0) + n
        if ops:
            return ms, sum(ops.values()), ops
    raise AssertionError("the profiler saw no device operation of the call")


def int8_write_as_before(k, v, pk, pv, cks, cvs, bt, positions, valid):
    """The int8 KV write of ``_paged_attention`` before the fused write."""
    from repro_torch.kernels.kv_pack import pack_kv
    B, S = positions.shape
    ps, NB = pk.shape[1], bt.shape[1]
    bidx = torch.arange(B, device=k.device)[:, None]
    blk = torch.clamp(torch.div(positions, ps, rounding_mode="floor"),
                      0, NB - 1).long()
    zero = torch.zeros((), dtype=torch.long, device=k.device)
    page = torch.where(valid, bt.long()[bidx, blk], zero).reshape(-1)
    off = torch.where(valid, (positions % ps).long(), zero).reshape(-1)
    Hkv, hd = pk.shape[2], pk.shape[3]
    kw, ksc = pack_kv(k)
    vw, vsc = pack_kv(v)
    cks[page, off] = ksc.reshape(B * S, Hkv)
    cvs[page, off] = vsc.reshape(B * S, Hkv)
    pk[page, off] = kw.reshape(B * S, Hkv, hd).to(pk.dtype)
    pv[page, off] = vw.reshape(B * S, Hkv, hd).to(pv.dtype)


def stats_as_before(logical_idx, src2d, token_mask, sort_idx, E, n_sources):
    """The statistics call site of ``_ragged_moe_ffn`` as it was: the ids
    in the dispatch's sort order, counted by the memsets and the grid."""
    from repro_torch.kernels.source_expert_count import source_expert_count
    T, K = logical_idx.shape[0] * logical_idx.shape[1], logical_idx.shape[2]
    order = sort_idx.long()
    lg = logical_idx.reshape(T * K)[order].to(torch.int32)
    tok = torch.div(order, K, rounding_mode="floor")
    ss = src2d.reshape(T)[tok].to(torch.int32)
    ss = torch.where(token_mask.reshape(T)[tok], ss, torch.full_like(ss, -1))
    return source_expert_count(lg[:, None].contiguous(), ss.contiguous(),
                               n_experts=E, n_sources=n_sources,
                               single_block_slots=-1)[1]


def stats_as_now(logical_idx, src2d, token_mask, E, n_sources):
    """The call site as ``_ragged_moe_ffn`` now issues it."""
    from repro_torch.kernels.source_expert_count import source_expert_count
    T, K = logical_idx.shape[0] * logical_idx.shape[1], logical_idx.shape[2]
    ss = torch.where(token_mask.reshape(src2d.shape), src2d, -1)
    return source_expert_count(
        logical_idx.reshape(T, K).to(torch.int32).contiguous(),
        ss.reshape(T).to(torch.int32).contiguous(), n_experts=E,
        n_sources=n_sources)[1]


def write_case(B, S):
    g = torch.Generator(device="cuda").manual_seed(8)
    Hkv, hd, ps, NB = 4, 128, 16, 64
    P = B * NB + 1
    bt = (torch.randperm(P - 1, generator=g, device="cuda") + 1) \
        .reshape(B, NB).to(torch.int32)
    if S == 1:
        starts = torch.tensor([0, 1, 17, 255, 511, 700, 1000, 1023],
                              device="cuda")
        lens = torch.ones(B, dtype=torch.int32, device="cuda")
        lens[3] = 0
    else:
        starts = torch.full((B,), 37, device="cuda")
        lens = torch.full((B,), S - 12, dtype=torch.int32, device="cuda")
    positions = (starts[:, None] + torch.arange(S, device="cuda")) \
        .to(torch.int32)
    valid = torch.arange(S, device="cuda")[None] < lens[:, None]
    k, v = (torch.randn(B, S, Hkv, hd, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    pools = [torch.zeros(P, ps, Hkv, hd, dtype=torch.int8, device="cuda")
             for _ in range(2)] + \
        [torch.zeros(P, ps, Hkv, device="cuda") for _ in range(2)]
    return k, v, pools, (bt, positions, valid)


def stats_case(B, S, masked):
    from repro_torch.kernels.moe_dispatch import (pick_row_block,
                                                  ragged_dispatch)
    g = torch.Generator(device="cuda").manual_seed(3)
    E, K, D = 128, 8, 2048
    T = B * S
    logits = torch.randn(B, S, E, generator=g, device="cuda")
    ids = torch.topk(logits, K, dim=-1).indices.to(torch.int32)
    src2d = (torch.arange(B, device="cuda") % 2).to(torch.int32)[:, None] \
        .expand(B, S)
    mask = torch.ones(B, S, dtype=torch.bool, device="cuda")
    mask.view(-1)[-masked:] = False
    x = torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)
    phys = torch.randperm(E, generator=g, device="cuda")[ids.long()] \
        .reshape(T, K)
    disp = ragged_dispatch(x, phys, E, row_block=pick_row_block(T * K, E))
    return ids, src2d, mask, disp.sort_idx, E


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("callsite_ab: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import kv_pack, ops
    from repro_torch.kernels.source_expert_count import source_expert_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    ops.build()
    timer = cs.Timer()
    out = {"card": smi, "items": {}}

    def item(name, fn):
        ev = timer(fn)
        dev, n_ops, names = device_ops(timer, fn)
        out["items"][name] = {"ms": ev, "device_ms": dev, "device_ops": n_ops,
                              "operations": names}
        print(f"{name}: event {ev:.4f} ms, device {dev:.4f} ms in {n_ops} "
              f"device operations per call", flush=True)

    k, v, pools, slots = write_case(8, 1)
    item("pack_kv decode (8, 1, 4, 128)", lambda: kv_pack.pack_kv(k))
    for B, S, which in ((8, 1, "decode"), (1, 512, "prefill 512")):
        k, v, pools, slots = write_case(B, S)
        item(f"int8 write as before, {which}",
             lambda: int8_write_as_before(k, v, *pools, *slots))
        item(f"int8 write fused, {which}",
             lambda: kv_pack.pack_kv_into_pages(k, v, *pools, *slots))
    g = torch.Generator(device="cuda").manual_seed(3)
    for T, K in ((8, 8), (2048, 1)):
        ids = torch.randint(-1, 128, (T, K), generator=g, device="cuda",
                            dtype=torch.int32)
        src = torch.randint(-1, 2, (T,), generator=g, device="cuda",
                            dtype=torch.int32)
        item(f"source_expert_count T={T} K={K}",
             lambda: source_expert_count(ids, src, n_experts=128,
                                         n_sources=2))
    for B, S, masked, which in ((8, 1, 1, "decode"),
                                (1, 512, 12, "prefill 512")):
        ids, src2d, mask, sort_idx, E = stats_case(B, S, masked)
        before = stats_as_before(ids, src2d, mask, sort_idx, E, 2)
        now = stats_as_now(ids, src2d, mask, E, 2)
        if not torch.equal(before, now):
            raise AssertionError(f"stats call sites disagree ({which})")
        item(f"stats call site as before, {which}",
             lambda: stats_as_before(ids, src2d, mask, sort_idx, E, 2))
        item(f"stats call site as now, {which}",
             lambda: stats_as_now(ids, src2d, mask, E, 2))
    for name, row in (
            ("moe_gmm_ragged decode gate/up", lambda: cs.check_gmm(
                timer, torch.bfloat16, 8, 2048, 768, "decode gate/up")),
            ("moe_gmm padded decode gate/up", lambda: cs.check_padded_gmm(
                timer, torch.bfloat16, 128, 4, 2048, 768, "decode gate/up")),
            ("unpack_kv (8, 1024, 4, 128)", lambda: cs.check_unpack(
                timer, torch.bfloat16, (8, 1024, 4, 128)))):
        r = row()
        out["items"][name] = {k: r[k] for k in (
            "ms", "device_ms", "library_ms", "library_device_ms") if k in r}
        print(f"{name}: {out['items'][name]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
