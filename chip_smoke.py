"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--layers 8] [--seed 0]

1. builds the CUDA kernels of ``src/repro_torch/csrc`` with nvcc;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and times both (CUDA events, L2
   flushed before every launch), and the one PyTorch call that computes the
   same function where there is one; every kernel and library call also
   gets its device time per call from ``torch.profiler`` (the kernels
   alone, without the wrapper's host work). The int8 KV write of a layer
   (``pack_kv_into_pages``, one launch) is held bit for bit to its plain
   twin on every page but the garbage page; the statistics kernel is held
   bit for bit on both its paths (one block, and the grid with its memsets
   above ``SINGLE_BLOCK_SLOTS``). For the two expert GEMMs and
   the two decode kernels it prints the route each shape took (tensor
   cores or CUDA cores); the decode kernels also get a row at a
   32768-token context, and each request's output row is held to its own
   norm as well (``decode_route.row_rel_err``), since at long contexts the
   outputs are far smaller than the absolute bf16 bar;
3. checks the port end to end on a small input: a float32 twin of the
   model served on the card through the kernels and on the CPU through the
   plain versions must give the same token streams and statistics, on one
   engine pair (split steps; mixed steps; int8 pages with mixed steps and
   prefix sharing, whose copy-on-write pages the fused write fills),
   through ``serve_real_cluster`` on int8 KV pages with experts migrating,
   without and with a crash of engine 1, and through
   ``serve_real_cluster`` over two dense-cache ``RealModelEngine``s in each
   MoE dispatch mode (ragged, capacity-padded), and through step 8's Queue C
   serve (same streams, (B, A) windows, prefix hits, copies, preemptions,
   swaps, recoveries and migrations);
4. serves 8 requests on two ``PagedRealEngine``s that share one runner, at
   the full width of Qwen3-30B-A3B (depth cut to ``--layers``), with random
   weights from ``--seed``, and checks what comes out: every request
   finished, tokens in the vocabulary, each kernel launched, and the MoE
   statistics B and A consistent with the tokens routed;
5. serves the same requests again under ``torch.profiler`` and prints the
   device's busy share and the kernels that take the device time (steps 6
   and 7 are profiled the same way);
6. serves 16 requests arriving over time through ``serve_real_cluster``
   (the Gimbal control plane: Algorithm-1 dispatch, profiler, placement,
   expert migration) on two engines with int8 KV pages at the same width,
   and checks that every request finished, both engines served, experts
   migrated on the card, and all five kernels of that path launched; its
   profile must show one int8 KV write kernel per layer-step and one
   single-block statistics kernel per MoE layer-step;
7. serves 16 requests arriving over time through ``serve_real_cluster`` on
   two dense-cache ``RealModelEngine``s with the capacity-padded MoE
   dispatch at the same width (8 slots of 1024 tokens each), experts
   migrating, and checks the same, with ``flash_decode`` and ``moe_gmm``
   launched;
8. the scenario phase, at the same width on bf16 pages with prefix sharing
   and mixed steps: serves the real slices of the ``agentic_sessions`` and
   ``chat_oneshot`` scenarios through ``serve_real_cluster`` (the session
   slice profiled; the invariant pack green, the sessions out-hitting the
   one-shot prompts);
   holds the sim<->real gate (the same session slice on the card and in
   ``simulate``: with the MoE-pressure feedback on, the same finishes,
   prefix hits and hit rate; with it off, affinity decisions as well);
   serves the session slice once more with every path of ROADMAP Queue C
   on (a tight pool that preempts by swapping to a host tier, predictive
   placement with staged prefetch, a crash and recovery of engine 1; step 3
   holds its float32 twin card against CPU); runs ``python -m
   repro_torch.launch.serve --real --paged`` and ``--real`` on the card, and
   the paged example's ``--shared-prefix`` and ``--chaos`` modes on the
   float32 twin, whose bit-identity asserts must hold;
9. prints a ``kernels`` JSON line (all seven kernels), then as its last
   line ``{"ok": true, "device": {...}}``.

The kernel launch counters are set to 0 just before each serve of steps 4,
6, 7 and of each scenario slice of step 8, and read just after; each serve
fails if a kernel of its path was not launched, or if a bf16 launch of an
expert GEMM or of a decode kernel at full width took the CUDA cores instead
of the tensor cores.

Any failure raises, and the script exits non-zero. It never runs on the
CPU: without a CUDA device it exits with an error before doing anything.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12           # HBM3, H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,      # dense tensor-core bf16
            "float32": 67e12,        # f32 outside the tensor cores
            "int32": 67e12}          # integer ALU, taken at the f32 rate
TOL = {"bfloat16": 3e-2, "float32": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8,
                    help="depth of the served model (the full model has 48)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


# ------------------------------------------------------------------ timing
class Timer:
    """Mean CUDA-event time of ``fn`` with L2 flushed before each launch,
    and (``device``) its device time from torch.profiler."""

    def __init__(self, iters: int = 10, warmup: int = 2):
        self.iters, self.warmup = iters, warmup
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        total = 0.0
        for _ in range(self.iters):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / self.iters

    def device(self, fn, match=None, n_kernels=None):
        """Mean device time per call of ``fn`` from torch.profiler, L2
        flushed before each call: the kernels alone, without the host work
        around them. ``match``: the ``n_kernels`` kernels whose names hold
        one of these; None: every device event of ``fn`` (a library call,
        whatever kernels it picks), the flush left out: here the flush is a
        bitwise_not, a kernel no timed function launches. The profiler now
        and then drops an event, or every event of a profile: a profile is
        taken (up to four times) until it holds each kernel at least once a
        call less one event (launches per call: its count over the calls,
        rounded), and, for a library call, until two such profiles agree on
        its kernels, so that one the profiler missed entirely shows. A
        kernel's time per call is its mean over its events times its
        launches per call. Returns (ms, {kernel: ms})."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        seen, complete = set(), 0
        for _ in range(4):
            parts, counts = {}, {}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(self.iters):
                    self.flush_buf.bitwise_not_()
                    fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA or "bitwise_not" in e.key:
                    continue
                hit = [m for m in match if m in e.key] if match else [""]
                if not hit:
                    continue
                name = re.search(r"\w*" + hit[0] + r"\w*", e.key).group(0) \
                    if match else e.key[:60]
                parts[name] = parts.get(name, 0.0) \
                    + e.self_device_time_total / 1e3
                counts[name] = counts.get(name, 0) + e.count
            per_call = {k: max(1, round(n / self.iters))
                        for k, n in counts.items()}
            whole = bool(counts) and all(
                n >= per_call[k] * self.iters - 1 for k, n in counts.items())
            if match:
                if whole and len(parts) == n_kernels:
                    break
                continue
            if not set(counts) <= seen:   # a kernel no earlier profile saw
                seen |= set(counts)
                complete = 0
            complete += whole and set(counts) == seen
            if complete == 2:
                break
        else:
            raise AssertionError(f"profiler did not see the kernels of "
                                 f"{match or 'the call'} in {self.iters} "
                                 f"calls (less one event) in four tries: "
                                 f"{counts}")
        per_call = {k: parts[k] / counts[k] * per_call[k] for k in parts}
        return sum(per_call.values()), per_call


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------------ kernels
def route_name(tc_launched: int) -> str:
    return "tensor cores" if tc_launched else "CUDA cores"


DECODE_KERNELS = ("decode_partial", "decode_tc", "combine")  # both passes


def device_times(timer, run, match=DECODE_KERNELS, n_kernels=2):
    """The kernel's device time per call (the decode kernels: both
    passes)."""
    ms, parts = timer.device(run, match, n_kernels=n_kernels)
    return {"device_ms": ms, "device_parts": parts}


def library_times(timer, run):
    """Event and device time of a library call, the yardstick of a row."""
    ms, parts = timer.device(run)
    return {"library_ms": timer(run), "library_device_ms": ms,
            "library_device_parts": parts}


def check_paged_decode(timer, dtype, int8_pages=False, long_ctx=False):
    """The serving shape (8 requests up to 1024 tokens, lane 0 empty), or a
    32768-token context over a pool of 16385 pages (0.54 GB in bf16)."""
    from repro_torch.kernels.decode_route import row_rel_err
    from repro_torch.kernels.kv_pack import pack_kv_plain
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, Hq, Hkv, hd, ps = 8, 32, 4, 128, 16
    if long_ctx:
        NB, P = 2048, 16385
        ctx = [32768, 30000, 26000, 20000, 16384, 9000, 4000, 1]
    else:
        NB, P = 64, 8 * 64 + 1
        ctx = [0, 1, 17, 256, 511, 700, 1000, 1024]      # lane 0 empty
    q = torch.randn(B, Hq, hd, generator=g, device="cuda").to(dtype)
    kp = torch.randn(P, ps, Hkv, hd, generator=g, device="cuda").to(dtype)
    vp = torch.randn(P, ps, Hkv, hd, generator=g, device="cuda").to(dtype)
    scales = {}
    if int8_pages:
        kp, ks = pack_kv_plain(kp)
        vp, vs = pack_kv_plain(vp)
        scales = dict(k_scales=ks, v_scales=vs)
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    bt = torch.zeros(B, NB, dtype=torch.int32, device="cuda")
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // ps)
        bt[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    tc_before = paged_decode.tc_launches
    out = paged_decode(q, kp, vp, bt, ctx_t, **scales)
    route = route_name(paged_decode.tc_launches - tc_before)
    ref = paged_decode_plain(q, kp, vp, bt, ctx_t, *scales.values())
    torch.cuda.synchronize()
    err, rel = max_err(out, ref), row_rel_err(out, ref)
    if not torch.isfinite(out).all() or \
            (ctx[0] == 0 and out[0].abs().max() != 0):
        raise AssertionError("paged_decode: non-finite output or a ctx=0 "
                             "lane that is not exactly zero")
    del ref
    item = q.element_size()
    live = sum(ctx)
    # K and V of the live tokens (and their scales on int8 pages)
    row_bytes = hd * kp.element_size() + (4 if int8_pages else 0)
    nbytes = 2 * q.numel() * item + live * Hkv * 2 * row_bytes \
        + bt.numel() * 4 + B * 4
    ops = 4.0 * live * Hq * hd
    pages = "int8 pages + f32 scales" if int8_pages else "pages in q's type"
    ctx_s = f"ctx={ctx}" if not long_ctx else \
        f"long context: ctx={ctx}, NB={NB}, pool of {P} pages"
    run = lambda: paged_decode(q, kp, vp, bt, ctx_t, **scales)  # noqa: E731
    return {"shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps} {ctx_s}, "
                     f"{pages}",
            "err": err, "row_rel_err": rel,
            "ms": timer(run), **device_times(timer, run),
            "plain_ms": timer(lambda: paged_decode_plain(
                q, kp, vp, bt, ctx_t, *scales.values())),
            "bound": bound_ms(nbytes, ops, str(dtype).split(".")[1]),
            "library_ms": None, "route": route}


def dispatch_layout(T, K, E, D, dtype, g):
    from repro_torch.kernels.moe_dispatch import pick_row_block, ragged_dispatch
    logits = torch.randn(T, E, generator=g, device="cuda")
    ids = torch.topk(logits, K, dim=-1).indices.to(torch.int32)
    x = torch.randn(T, D, generator=g, device="cuda").to(dtype)
    nb = pick_row_block(T * K, E)
    return ragged_dispatch(x, ids, E, row_block=nb)


def check_gmm(timer, dtype, T, D, F, which):
    from repro_torch.kernels.moe_gmm import (moe_gmm_ragged,
                                             moe_gmm_ragged_plain)
    g = torch.Generator(device="cuda").manual_seed(2)
    E, K = 128, 8
    disp = dispatch_layout(T, K, E, D, dtype, g)
    w = (torch.randn(E, D, F, generator=g, device="cuda")
         / np.sqrt(D)).to(dtype)
    args = (disp.xs, w, disp.tile_expert, disp.group_sizes,
            disp.padded_offsets)
    nb = disp.row_block
    tc_before = moe_gmm_ragged.tc_launches
    out = moe_gmm_ragged(*args, n_block=nb)
    route = route_name(moe_gmm_ragged.tc_launches - tc_before)
    ref = moe_gmm_ragged_plain(*args, n_block=nb)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    item = disp.xs.element_size()
    rows = int(disp.group_sizes.sum())
    hit = int((disp.group_sizes > 0).sum())
    Np = disp.xs.shape[0]
    nbytes = rows * D * item + hit * D * F * item + Np * F * 4 \
        + 4 * (disp.tile_expert.numel() + 2 * E + 1)
    ops = 2.0 * rows * D * F
    lib = {"library_ms": None}
    if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        offs = disp.padded_offsets[1:].contiguous()
        # bf16 out: the library rounds its output to the input type
        lib = library_times(timer, lambda: torch._grouped_mm(disp.xs, w,
                                                             offs=offs))
    run = lambda: moe_gmm_ragged(*args, n_block=nb)  # noqa: E731
    return {"shape": f"{which}: T={T} K={K} E={E} D={D} F={F} nb={nb} "
                     f"Np={Np} rows={rows} experts_hit={hit}",
            "err": err, "ms": timer(run),
            **device_times(timer, run, ("gmm_",), 1),
            "plain_ms": timer(lambda: moe_gmm_ragged_plain(*args,
                                                           n_block=nb)),
            "bound": bound_ms(nbytes, ops, str(dtype).split(".")[1]),
            **lib, "route": route}


def check_flash_decode(timer, dtype, long_ctx=False):
    """The dense ring cache of a RealModelEngine at full width: 8 slots of
    1024, rows at assorted write positions (one wrapped past the end of
    the ring, one fully masked: exact zeros); or 8 rings of 32768 slots,
    most of them full."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_route import row_rel_err
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.models.attention import ring_positions
    g = torch.Generator(device="cuda").manual_seed(6)
    B, Hq, Hkv, hd = 8, 32, 4, 128
    if long_ctx:
        L = 32768
        write = [32767, 40000, 65535, 32767, 50000, 32767, 20000, 32767]
    else:
        L = 1024
        write = [99, 1500, 255, 600, 931, 1023, 0, 400]     # row 1 wrapped
    q = torch.randn(B, Hq, hd, generator=g, device="cuda").to(dtype)
    kc = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dtype)
    vc = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dtype)
    write = torch.tensor(write, device="cuda")
    k_pos = ring_positions(write, L)
    q_pos = write.to(torch.int32)
    if not long_ctx:
        k_pos[6] = -1                                  # row 6: no valid slot
    tc_before = flash_decode.tc_launches
    out = flash_decode(q, kc, vc, k_pos, q_pos)
    route = route_name(flash_decode.tc_launches - tc_before)
    ref = flash_decode_plain(q, kc, vc, k_pos, q_pos)
    torch.cuda.synchronize()
    err, rel = max_err(out, ref), row_rel_err(out, ref)
    if not torch.isfinite(out).all() or \
            (not long_ctx and out[6].abs().max() != 0):
        raise AssertionError("flash_decode: non-finite output or a row with "
                             "no valid slot that is not exactly zero")
    del ref
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    n_valid = int(valid.sum())
    item = q.element_size()
    nbytes = 2 * q.numel() * item + n_valid * Hkv * 2 * hd * item \
        + k_pos.numel() * 4 + B * 4
    ops = 4.0 * n_valid * Hq * hd
    # the library yardstick: SDPA on the same cache, heads-first copies and
    # the boolean mask built outside the timed call
    q4 = q[:, :, None].contiguous()                    # (B, Hq, 1, hd)
    k4, v4 = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    mask = valid[:, None, None, :]
    lib = lib_dev = None
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    try:
        sdpa()
    except (TypeError, RuntimeError) as exc:
        log(f"library: scaled_dot_product_attention with enable_gqa not "
            f"timed ({exc})")
    else:
        # event time as for every library call, and device time, to set
        # against the kernel's own device time without either's host work
        lib = timer(sdpa)
        lib_dev = dict(zip(("library_device_ms", "library_device_parts"),
                           timer.device(sdpa)))
    what = (f"long context: L={L} ring, write positions {write.tolist()}"
            if long_ctx else f"L={L} ring, write positions "
            f"{write.tolist()}, row 6 masked")
    run = lambda: flash_decode(q, kc, vc, k_pos, q_pos)  # noqa: E731
    return {"shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} {what}, "
                     f"{n_valid} valid slots",
            "err": err, "row_rel_err": rel,
            "ms": timer(run), **device_times(timer, run),
            "plain_ms": timer(lambda: flash_decode_plain(q, kc, vc, k_pos,
                                                         q_pos)),
            "bound": bound_ms(nbytes, ops, str(dtype).split(".")[1]),
            "library_ms": lib, **(lib_dev or {}), "route": route}


def check_padded_gmm(timer, dtype, E, C, D, F, which):
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(E, C, D, generator=g, device="cuda").to(dtype)
    w = (torch.randn(E, D, F, generator=g, device="cuda")
         / np.sqrt(D)).to(dtype)
    tc_before = moe_gmm.tc_launches
    out = moe_gmm(x, w)
    route = route_name(moe_gmm.tc_launches - tc_before)
    ref = moe_gmm_plain(x, w)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    item = x.element_size()
    nbytes = (x.numel() + w.numel()) * item + out.numel() * 4
    # the library yardstick: one torch.bmm in the input type (its output is
    # rounded to that type)
    run = lambda: moe_gmm(x, w)  # noqa: E731
    return {"shape": f"{which}: ({E}, {C}, {D}) x ({E}, {D}, {F})",
            "err": err, "ms": timer(run),
            **device_times(timer, run, ("gmm_",), 1),
            "plain_ms": timer(lambda: moe_gmm_plain(x, w)),
            "bound": bound_ms(nbytes, 2.0 * E * C * D * F,
                              str(dtype).split(".")[1]),
            **library_times(timer, lambda: torch.bmm(x, w)), "route": route}


def check_stats(timer, T, K):
    """Up to SINGLE_BLOCK_SLOTS slots (every call of the int8 cluster serve)
    the kernel is one block: one launch, no memset. Above it (a padded
    prefill group of 4 lanes x 512 tokens at top-8 is 16384 slots) two
    memsets and the grid; its device time counts the memsets."""
    from repro_torch.kernels.source_expert_count import (
        SINGLE_BLOCK_SLOTS, source_expert_count, source_expert_count_plain)
    g = torch.Generator(device="cuda").manual_seed(3)
    E, S = 128, 2
    ids = torch.randint(-1, E, (T, K), generator=g, device="cuda",
                        dtype=torch.int32)
    src = torch.randint(-1, S, (T,), generator=g, device="cuda",
                        dtype=torch.int32)
    kw = dict(n_experts=E, n_sources=S)
    b, a = source_expert_count(ids, src, **kw)
    rb, ra = source_expert_count_plain(ids, src, **kw)
    # the library yardstick: one torch.bincount over (src + 1) * E + e of
    # the valid ids; rows 1..S are A, column sums are B (a source of -1
    # still counts in B). The keys are built outside the timed call.
    valid = ids >= 0
    keys = ((src[:, None].long() + 1) * E + ids.long())[valid]
    lib = torch.bincount(keys, minlength=(S + 1) * E).reshape(S + 1, E)
    torch.cuda.synchronize()
    if not (torch.equal(b, rb) and torch.equal(a, ra)):
        raise AssertionError(f"source_expert_count differs at T={T} K={K}")
    lib_ok = torch.equal(lib[1:].int(), a) and torch.equal(lib.sum(0).int(), b)
    if not lib_ok:
        log("library: torch.bincount does not reproduce (B, A); not timed")
    nbytes = 4 * (ids.numel() + src.numel() + E + S * E)
    run = lambda: source_expert_count(ids, src, **kw)  # noqa: E731
    one_block = T * K <= SINGLE_BLOCK_SLOTS
    path = (("source_expert_count_block",), 1) if one_block \
        else (("source_expert_count_grid", "Memset"), 2)
    return {"shape": f"T={T} K={K} E={E} S={S} (ids include -1), "
                     f"{'one block' if one_block else 'grid, two memsets'}",
            "err": 0.0, "ms": timer(run),
            **device_times(timer, run, *path),
            "plain_ms": timer(lambda: source_expert_count_plain(ids, src,
                                                                **kw)),
            "bound": bound_ms(nbytes, 2.0 * ids.numel(), "int32"),
            **(library_times(timer, lambda: torch.bincount(
                keys, minlength=(S + 1) * E)) if lib_ok
               else {"library_ms": None})}


def check_pack(timer, dtype, shape, which):
    from repro_torch.kernels.kv_pack import pack_kv, pack_kv_plain
    g = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randn(shape, generator=g, device="cuda")
         * torch.rand(shape[:-1] + (1,), generator=g, device="cuda")
         * 8).to(dtype)
    q, s = pack_kv(x)
    rq, rs = pack_kv_plain(x)
    torch.cuda.synchronize()
    if not (torch.equal(q, rq) and torch.equal(s, rs)):
        raise AssertionError(f"pack_kv [{dtype}] {shape}: codes or scales "
                             "differ from the plain version")
    rows, hd = s.numel(), shape[-1]
    nbytes = rows * hd * x.element_size() + rows * hd + rows * 4
    # |x|, max, one division and one conversion per value, at the f32 rate
    run = lambda: pack_kv(x)  # noqa: E731
    return {"shape": f"{which}: {tuple(shape)} (tokens, heads, hd)",
            "err": 0.0, "ms": timer(run),
            **device_times(timer, run, ("pack_kv_kernel",), 1),
            "plain_ms": timer(lambda: pack_kv_plain(x)),
            "bound": bound_ms(nbytes, 4.0 * rows * hd, "float32"),
            "library_ms": None}


def check_pack_paged(timer, dtype, B, S, which):
    """The whole int8 KV write of one layer in one launch: K and V of a
    (B, S) chunk at full width (4 KV heads of 128) into a pool of int8
    pages of 16 tokens, against the plain twin (``pack_kv_plain`` and the
    four index-puts), bit for bit on every page but page 0, where invalid
    rows race. Decode: 8 lanes at assorted contexts, lane 3 idle; prefill:
    one 512-token chunk starting mid-page, its last 12 rows padding."""
    from repro_torch.kernels.kv_pack import (pack_kv_into_pages,
                                             pack_kv_into_pages_plain)
    g = torch.Generator(device="cuda").manual_seed(8)
    Hkv, hd, ps, NB = 4, 128, 16, 64
    P = B * NB + 1
    bt = (torch.randperm(P - 1, generator=g, device="cuda") + 1) \
        .reshape(B, NB).to(torch.int32)
    if S == 1:
        starts = torch.tensor([0, 1, 17, 255, 511, 700, 1000, 1023],
                              device="cuda")[:B]
        lens = torch.ones(B, dtype=torch.int32, device="cuda")
        lens[3 % B] = 0
    else:
        starts = torch.full((B,), 37, device="cuda")
        lens = torch.full((B,), S - 12, dtype=torch.int32, device="cuda")
    positions = (starts[:, None] + torch.arange(S, device="cuda")) \
        .to(torch.int32)
    valid = torch.arange(S, device="cuda")[None] < lens[:, None]
    k, v = ((torch.randn(B, S, Hkv, hd, generator=g, device="cuda")
             * torch.rand(B, S, Hkv, 1, generator=g, device="cuda") * 8)
            .to(dtype) for _ in range(2))
    pools = [torch.randint(-127, 128, (P, ps, Hkv, hd), generator=g,
                           device="cuda", dtype=torch.int8)
             for _ in range(2)] + \
        [torch.rand(P, ps, Hkv, generator=g, device="cuda") for _ in range(2)]
    plain = [t.clone() for t in pools]
    args = (bt, positions, valid)
    pack_kv_into_pages(k, v, *pools, *args)
    pack_kv_into_pages_plain(k, v, *plain, *args)
    torch.cuda.synchronize()
    if not all(torch.equal(a[1:], b[1:]) for a, b in zip(pools, plain)):
        raise AssertionError(f"pack_kv_into_pages [{dtype}] {which}: codes "
                             "or scales differ from the plain twin")
    n, n_valid = B * S * Hkv, int(valid.sum()) * Hkv
    # K and V read, codes and scales of the valid rows written, the slots
    nbytes = 2 * (n * hd * k.element_size() + n_valid * (hd + 4)) \
        + 4 * (bt.numel() + positions.numel()) + valid.numel()
    run = lambda: pack_kv_into_pages(k, v, *pools, *args)  # noqa: E731
    return {"shape": f"{which}: K and V ({B}, {S}, {Hkv}, {hd}) into int8 "
                     f"pages of {ps}, {int(valid.sum())} valid rows "
                     f"(one launch: slots, quantization, scatter)",
            "err": 0.0, "ms": timer(run),
            **device_times(timer, run, ("pack_kv_kernel",), 1),
            "plain_ms": timer(lambda: pack_kv_into_pages_plain(
                k, v, *plain, *args)),
            "bound": bound_ms(nbytes, 2 * 4.0 * n * hd, "float32"),
            "library_ms": None}


def check_unpack(timer, dtype, shape):
    from repro_torch.kernels.kv_pack import unpack_kv, unpack_kv_plain
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randint(-127, 128, shape, generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(shape[:-1], generator=g, device="cuda") * 0.05
    out = unpack_kv(q, s, dtype)
    ref = unpack_kv_plain(q, s, dtype)
    # the library yardstick: one torch.mul computing in f32 into an output
    # of the target type
    buf = torch.empty(shape, dtype=dtype, device="cuda")
    torch.mul(q, s[..., None], out=buf)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"unpack_kv [{dtype}] {shape}: differs from "
                             "the plain version")
    lib_ok = torch.equal(buf, ref)
    if not lib_ok:
        log(f"library: torch.mul into {dtype} does not reproduce unpack_kv; "
            "not timed")
    n = q.numel()
    nbytes = n + s.numel() * 4 + n * out.element_size()
    run = lambda: unpack_kv(q, s, dtype)  # noqa: E731
    return {"shape": f"prefill gather: {tuple(shape)} (B, L, Hkv, hd)",
            "err": 0.0, "ms": timer(run),
            **device_times(timer, run, ("unpack_kv_kernel",), 1),
            "plain_ms": timer(lambda: unpack_kv_plain(q, s, dtype)),
            "bound": bound_ms(nbytes, 2.0 * n, "float32"),
            **(library_times(timer, lambda: torch.mul(q, s[..., None],
                                                      out=buf))
               if lib_ok else {"library_ms": None})}


def kernel_phase():
    """Each kernel against its plain version at the serving shapes."""
    from repro_torch.kernels.decode_route import ROW_TOL
    timer = Timer()
    results = {"paged_decode": [], "moe_gmm_ragged": [],
               "source_expert_count": [], "pack_kv": [], "unpack_kv": [],
               "flash_decode": [], "moe_gmm": []}

    def record(kname, dt, r):
        tol = TOL.get(dt.split("/")[0], 0.0)
        ok = r["err"] <= tol
        rel = ""
        if "row_rel_err" in r:      # the decode kernels: each row's own norm
            rel_tol = ROW_TOL[getattr(torch, dt.split("/")[0])]
            ok = ok and r["row_rel_err"] <= rel_tol
            rel = (f", row_rel_err {r['row_rel_err']:.3g} (tolerance "
                   f"{rel_tol:g})")
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        if "library_device_ms" in r:
            lib += f" (device {r['library_device_ms']:.4f} ms)"
        route = f"route {r['route']}, " if "route" in r else ""
        dev = ""
        if "device_ms" in r:
            parts = " + ".join(f"{k} {v:.4f}"
                               for k, v in r["device_parts"].items())
            dev = f" (device {r['device_ms']:.4f} ms = {parts})"
        log(f"kernel {kname} [{dt}] {r['shape']}: max_abs_err "
            f"{r['err']:.3g} (tolerance {tol:g}){rel} "
            f"{'ok' if ok else 'FAIL'}; "
            f"{route}kernel {r['ms']:.4f} ms{dev}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), library {lib}")
        if not ok:
            raise AssertionError(f"{kname} [{dt}] disagrees with its plain "
                                 f"version: max_abs_err {r['err']} (tolerance "
                                 f"{tol}){rel}")
        if kname.endswith("_decode") and dt.startswith("bfloat16") \
                and r["route"] == "CUDA cores":
            raise AssertionError(f"{kname} [{dt}] {r['shape']}: took the "
                                 "CUDA cores at a full-width bf16 shape")
        results[kname].append((dt, r))

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        record("paged_decode", dt, check_paged_decode(timer, dtype))
        record("paged_decode", dt + "/int8",
               check_paged_decode(timer, dtype, int8_pages=True))
        # the int8 KV write of a layer, as the main path issues it (the
        # kernels line's pack_kv row is its decode shape), then the plain
        # pack, the counterpart of pack_kv_pallas
        for B, S, which in ((8, 1, "decode"), (1, 512, "prefill chunk")):
            record("pack_kv", dt + "/paged",
                   check_pack_paged(timer, dtype, B, S, which))
        for shape, which in (((8, 1, 4, 128), "decode"),
                             ((512, 4, 128), "prefill")):
            record("pack_kv", dt, check_pack(timer, dtype, shape, which))
        record("unpack_kv", dt, check_unpack(timer, dtype, (8, 1024, 4, 128)))
        for T, which in ((8, "decode"), (256, "prefill")):
            for D, F, proj in ((2048, 768, "gate/up"), (768, 2048, "down")):
                record("moe_gmm_ragged", dt,
                       check_gmm(timer, dtype, T, D, F,
                                 f"{which} {proj}"))
        record("flash_decode", dt, check_flash_decode(timer, dtype))
        if dtype == torch.bfloat16:       # the long-context rows, then free
            record("paged_decode", dt,
                   check_paged_decode(timer, dtype, long_ctx=True))
            record("paged_decode", dt + "/int8",
                   check_paged_decode(timer, dtype, int8_pages=True,
                                      long_ctx=True))
            record("flash_decode", dt,
                   check_flash_decode(timer, dtype, long_ctx=True))
            torch.cuda.empty_cache()
        # capacity C = max(ceil(S * K * 1.25 / E), 4): 4 at a decode step of
        # 8 slots (one regrouped dispatch), 71 at a 900-token prefill
        for E, C, D, F, which in (
                (128, 4, 2048, 768, "decode gate/up"),
                (128, 4, 768, 2048, "decode down"),
                (128, 71, 2048, 768, "prefill gate/up S=900"),
                (128, 71, 768, 2048, "prefill down S=900"),
                (6, 37, 100, 130, "odd C, D, F")):
            record("moe_gmm", dt,
                   check_padded_gmm(timer, dtype, E, C, D, F, which))
    # a decode step first (the kernels line's row), then a 256-token chunk,
    # the grid above SINGLE_BLOCK_SLOTS, and the sorted-ids shape of before
    for T, K in ((8, 8), (256, 8), (2048, 8), (2048, 1)):
        record("source_expert_count", "int32",
               check_stats(timer, T, K))
    return results


# ------------------------------------------------------------------ serving
def reset_counts(counters):
    """Every launch counter of ``counters`` (and the tensor-core counters
    of the GMMs and the decode kernels) to 0, just before a serve."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0


def read_counts(counters):
    """(launches, tensor-core launches of the kernels that have two
    routes), just after a serve."""
    return ({name: fn.launches for name, fn in counters.items()},
            {name: fn.tc_launches for name, fn in counters.items()
             if hasattr(fn, "tc_launches")})


def check_routes(phase, launches, tc, mains):
    """At full width in bf16 every launch of an expert GEMM or a decode
    kernel takes the tensor cores: each kernel of ``mains`` (the path's GEMM
    and decode kernel) launched there, none on the CUDA cores."""
    for name, n_tc in tc.items():
        if launches[name] - n_tc:
            raise AssertionError(f"{phase}: {name} took the CUDA cores "
                                 f"{launches[name] - n_tc} times at full "
                                 f"width in bf16")
    for main in mains:
        if tc[main] <= 0:
            raise AssertionError(f"{phase}: {main} never took the tensor "
                                 "cores")


def make_requests(cfg, n, lo, hi, max_new, seed, gap=0.001, shared=0):
    """``n`` requests with prompts of ``lo`` to ``hi`` random tokens, each
    after a common prefix of ``shared`` tokens."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, shared).tolist()
    reqs = []
    for i in range(n):
        toks = prefix + rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(lo, hi + 1))).tolist()
        reqs.append(Request(req_id=i, prompt_len=len(toks),
                            max_new_tokens=max_new, arrival_time=gap * i,
                            prompt_tokens=toks))
    return reqs


def serve(cfg, params, ecfg, reqs, every=0):
    """Two engines on one runner; requests alternate between them, request
    i arriving before step ``i * every``. Returns (engines, per-step
    seconds, wall seconds, (B, A) per engine)."""
    from repro_torch.serving import (PagedModelRunner, PagedRealEngine)
    runner = PagedModelRunner(cfg, params, ecfg, n_sources=2)
    engines = [PagedRealEngine(i, cfg, params, ecfg, runner=runner)
               for i in range(2)]
    cuda = ecfg.device == "cuda"
    steps, now = [], 0.0
    waiting = list(enumerate(reqs))
    t_all = time.perf_counter()
    for n in range(10001):
        while waiting and waiting[0][0] * every <= n:
            i, r = waiting.pop(0)
            engines[i % 2].enqueue(r, now)
        if not waiting and not any(e.has_work for e in engines):
            break
        for e in engines:
            if not e.has_work:
                continue
            t0 = time.perf_counter()
            e.step(now)
            if cuda:
                torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        now += 0.01
    else:
        raise AssertionError("serving did not finish in 10000 rounds")
    wall = time.perf_counter() - t_all
    return engines, steps, wall, [e.window_stats() for e in engines]


def serve_cluster(cfg, params, ecfg, reqs, **cluster_kw):
    """``serve_real_cluster`` on two engines sharing one runner. Returns
    (SimResult, engines, wall seconds)."""
    from repro_torch.serving import (PagedModelRunner, PagedRealEngine,
                                     RealClusterConfig, serve_real_cluster)
    runner = PagedModelRunner(cfg, params, ecfg, n_sources=2)
    engines = [PagedRealEngine(i, cfg, params, ecfg, runner=runner)
               for i in range(2)]
    t0 = time.perf_counter()
    res = serve_real_cluster(reqs, engines,
                             cluster_cfg=RealClusterConfig(**cluster_kw))
    if ecfg.device == "cuda":
        torch.cuda.synchronize()
    return res, engines, time.perf_counter() - t0


def serve_dense_cluster(cfg, params, reqs, *, device, ragged, max_slots,
                        max_len, **cluster_kw):
    """``serve_real_cluster`` on two dense-cache ``RealModelEngine``s, each
    holding the same initial params. Returns (SimResult, engines, wall s,
    the peak KV occupancy the engines' traces reported)."""
    from repro_torch.serving import (RealClusterConfig, RealModelEngine,
                                     serve_real_cluster)
    engines = [RealModelEngine(i, cfg, params, max_slots=max_slots,
                               max_len=max_len, ragged_dispatch=ragged,
                               device=device) for i in range(2)]
    # the cluster's kv_peak reads page pools, which dense engines do not
    # have: take the peak of the traces' token-level kv_usage instead
    peak = [0.0]
    for e in engines:
        def trace(now, _trace=e.trace, **kw):
            t = _trace(now, **kw)
            peak[0] = max(peak[0], t.kv_usage)
            return t
        e.trace = trace
    t0 = time.perf_counter()
    res = serve_real_cluster(reqs, engines,
                             cluster_cfg=RealClusterConfig(**cluster_kw))
    if device == "cuda":
        torch.cuda.synchronize()
    return res, engines, time.perf_counter() - t0, peak[0]


def dense_cluster_reference(cfg, params, params_gpu):
    """The float32 twin through serve_real_cluster over two dense-cache
    engines, experts migrating, in each dispatch mode: the card and the CPU
    give the same streams, decisions and migrations."""
    from repro_torch.core import PlacementConfig
    keys = ("decisions", "migrations", "expert_moves", "per_engine",
            "unfinished", "kv_peak")
    for ragged in (True, False):
        out = {}
        for dev, p in (("cpu", params), ("cuda", params_gpu)):
            reqs = make_requests(cfg, 8, 6, 30, 5, seed=7, gap=0.1)
            res, _, _, _ = serve_dense_cluster(
                cfg, p, reqs, device=dev, ragged=ragged, max_slots=4,
                max_len=64, window_tokens=48,
                placement_cfg=PlacementConfig.uncalibrated())
            out[dev] = ([r.full_output_tokens for r in reqs],
                        {k: res.signals[k] for k in keys})
        mode = "ragged" if ragged else "padded"
        (toks_c, sig_c), (toks_g, sig_g) = out["cpu"], out["cuda"]
        if toks_c != toks_g or sig_c != sig_g:
            diff = [k for k in keys if sig_c[k] != sig_g[k]]
            raise AssertionError(f"float32 twin dense cluster ({mode} "
                                 f"dispatch): card and CPU disagree (tokens "
                                 f"equal: {toks_c == toks_g}; signals that "
                                 f"differ: {diff})")
        if sig_g["migrations"] <= 0 or sig_g["unfinished"]:
            raise AssertionError(f"float32 twin dense cluster ({mode}): "
                                 f"expected migrations and a finished run, "
                                 f"got {sig_g}")
        log(f"reference: float32 twin dense cluster, {mode} dispatch: card "
            f"kernels and CPU plain versions give the same "
            f"{sum(map(len, toks_c))} tokens, decisions "
            f"{sig_g['decisions']}, {sig_g['migrations']} migrations "
            f"({sig_g['expert_moves']} expert moves)")


def cluster_reference(cfg, params, params_gpu):
    """The float32 twin through serve_real_cluster on int8 pages, experts
    migrating, without and with a crash of engine 1: the card and the CPU
    give the same streams, decisions, migrations and fault telemetry."""
    from repro_torch.core import PlacementConfig
    from repro_torch.ft import FaultEvent, FaultPlan, HealthConfig
    from repro_torch.serving import PagedEngineConfig
    crash = FaultPlan(events=(FaultEvent("crash", 1, 8),
                              FaultEvent("recover", 1, 16)))
    keys = ("decisions", "migrations", "expert_moves", "recovered_requests",
            "health_events", "per_engine", "n_failures", "unfinished")
    for plan in (None, crash):
        out = {}
        for dev, p in (("cpu", params), ("cuda", params_gpu)):
            ecfg = PagedEngineConfig(page_size=8, n_pages=48,
                                     max_blocks_per_req=8, max_batch=4,
                                     token_budget=16, chunk_buckets=(8, 16),
                                     kv_dtype="int8", device=dev)
            reqs = make_requests(cfg, 8, 6, 30, 5, seed=5, gap=0.1)
            res, _, _ = serve_cluster(
                cfg, p, ecfg, reqs, window_tokens=48,
                placement_cfg=PlacementConfig.uncalibrated(),
                health_cfg=HealthConfig(trace_timeout_s=0.3),
                fault_plan=plan)
            out[dev] = ([r.full_output_tokens for r in reqs],
                        {k: res.signals[k] for k in keys})
        what = "with a crash of engine 1" if plan else "without faults"
        (toks_c, sig_c), (toks_g, sig_g) = out["cpu"], out["cuda"]
        if toks_c != toks_g or sig_c != sig_g:
            diff = [k for k in keys if sig_c[k] != sig_g[k]]
            raise AssertionError(f"float32 twin cluster on int8 pages "
                                 f"({what}): card and CPU disagree (tokens "
                                 f"equal: {toks_c == toks_g}; signals that "
                                 f"differ: {diff})")
        if sig_g["migrations"] <= 0 or sig_g["unfinished"] or \
                (plan is not None and sig_g["n_failures"] != 1):
            raise AssertionError(f"float32 twin cluster ({what}): expected "
                                 f"migrations and a finished run, got "
                                 f"{sig_g}")
        log(f"reference: float32 twin cluster on int8 pages, {what}: card "
            f"kernels and CPU plain versions give the same "
            f"{sum(map(len, toks_c))} tokens, decisions "
            f"{sig_g['decisions']}, {sig_g['migrations']} migrations "
            f"({sig_g['expert_moves']} expert moves), "
            f"{sig_g['recovered_requests']} recovered requests, health "
            f"events {[e['event'] for e in sig_g['health_events']]}")


def reference_phase():
    """A float32 twin served through the kernels on the card and through
    the plain versions on the CPU gives the same tokens and statistics."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import PagedEngineConfig
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    params_gpu = tree_map(lambda t: t.to("cuda"), params)
    sharing = dict(kv_dtype="int8", mixed_steps=True, prefix_sharing=True)
    for kw in (dict(), dict(mixed_steps=True), sharing):
        out = {}
        for dev, p in (("cpu", params), ("cuda", params_gpu)):
            ecfg = PagedEngineConfig(page_size=8, n_pages=64,
                                     max_blocks_per_req=8, max_batch=4,
                                     token_budget=16, chunk_buckets=(8, 16),
                                     device=dev, **kw)
            if kw is sharing:
                # a 20-token system prompt, requests two steps apart, so
                # that later ones find it registered and copy its
                # partial page on write
                reqs = make_requests(cfg, 6, 3, 30, 6, seed=11, shared=20)
                engines, _, _, stats = serve(cfg, p, ecfg, reqs, every=2)
            else:
                reqs = make_requests(cfg, 6, 3, 40, 6, seed=11)
                engines, _, _, stats = serve(cfg, p, ecfg, reqs)
            out[dev] = ([r.output_tokens for r in reqs], stats,
                        [(e.prefix_hit_tokens, e.pool.stat_cow_copies)
                         for e in engines])
        (toks_c, st_c, pre_c), (toks_g, st_g, pre_g) = out["cpu"], out["cuda"]
        same_stats = all(np.array_equal(a, b) for sc, sg in zip(st_c, st_g)
                         for a, b in zip(sc, sg))
        what = ", ".join(f"{k}={v}" for k, v in kw.items()) or "split steps"
        if toks_c != toks_g or not same_stats or pre_c != pre_g:
            raise AssertionError(f"float32 twin ({what}): card and CPU "
                                 f"disagree (tokens equal: {toks_c == toks_g}"
                                 f", statistics equal: {same_stats}, prefix "
                                 f"hits and copies {pre_g} against {pre_c})")
        hits, cows = (sum(x) for x in zip(*pre_g))
        if kw is sharing and not (hits and cows):
            raise AssertionError(f"float32 twin ({what}): expected prefix "
                                 f"hits and copy-on-write pages, got {hits} "
                                 f"hit tokens and {cows} copies")
        log(f"reference: float32 twin, {what}: card kernels and CPU plain "
            f"versions give the same {sum(map(len, toks_c))} tokens and B/A "
            f"statistics ({hits} prefix-hit tokens, {cows} copy-on-write "
            f"pages)")
    cluster_reference(cfg, params, params_gpu)
    dense_cluster_reference(cfg, params, params_gpu)
    queue_c_reference(cfg, params, params_gpu)


PROFILE_GROUPS = (("expert GEMM", ("gmm_",)),              # both, both routes
                  ("decode", DECODE_KERNELS),              # both passes
                  ("int8 KV write", ("::pack_kv_kernel",)),
                  ("stats", ("source_expert_count",)))


def profiled(label, run):
    """``run()`` under torch.profiler: the device's busy share of the wall
    time, and the kernels that take the device time. ``run`` returns a
    phrase saying what it served. The device alone is traced: tracing the
    host's operations too doubled a serve's wall time and took minutes to
    aggregate. Returns the device events, as (self device us, count, name)
    rows, and the wall seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        what = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a host op's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        raise AssertionError(f"profile {label}: the profiler recorded no "
                             "device events")
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile {label}: {what} in {wall * 1e3:.1f} ms wall (profiled), "
        f"device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / (wall * 1e3):.1f}% of the wall time")
    for what, match in PROFILE_GROUPS:
        mine = [r for r in rows if any(m in r[2] for m in match)]
        if not mine:
            continue

        def short(key):    # "void (anonymous namespace)::gmm_x<1, 1>(...)"
            i = key.find("::")
            return key[i + 2 if i >= 0 else 0:].split("(")[0]

        ms = sum(r[0] for r in mine) / 1e3
        parts = ", ".join(f"{short(k)} {us / 1e3:.1f} ms / {n}"
                          for us, n, k in sorted(mine, reverse=True))
        log(f"profile {label}: {what} kernels {ms:.1f} ms in "
            f"{sum(r[1] for r in mine)} launches = "
            f"{100 * ms / busy_ms:.1f}% of the device time ({parts})")
    for us, n, key in sorted(rows, reverse=True)[:12]:
        log(f"profile {label}:   {us / 1e3:9.2f} ms  {n:6d} calls  "
            f"{key[:90]}")
    return rows, wall


def counted_forwards(tfm, calls):
    """Wrap the paged model's two entry points (a mixed step goes through
    the prefill one) to count each forward pass into ``calls``; returns a
    function that restores them."""
    saved = {}
    for name in ("prefill_chunk_paged", "decode_step_paged"):
        fn = saved[name] = getattr(tfm, name)

        def counted(*a, _fn=fn, **kw):
            calls[0] += 1
            return _fn(*a, **kw)
        setattr(tfm, name, counted)
    return lambda: [setattr(tfm, n, f) for n, f in saved.items()]


def serve_phase(args, counters):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import PagedEngineConfig
    full = get_config("qwen3-moe-30b-a3b")
    cfg = reduced(full, n_layers=args.layers)
    log(f"reduced: n_layers {full.n_layers}→{cfg.n_layers} (width "
        f"unchanged: d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"hd={cfg.head_dim}, experts {cfg.moe.n_experts} top-"
        f"{cfg.moe.top_k}, d_expert={cfg.moe.d_expert}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype})")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = tfm.init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    log(f"init: random weights from seed {args.seed} on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    ecfg = PagedEngineConfig(page_size=16, n_pages=256,
                             max_blocks_per_req=64, max_batch=8,
                             token_budget=512,
                             chunk_buckets=(64, 128, 256, 512),
                             device="cuda")
    new_tokens = 32
    reqs = make_requests(cfg, 8, 100, 900, new_tokens, seed=args.seed)

    reset_counts(counters)
    engines, steps, wall, stats = serve(cfg, params, ecfg, reqs)
    launches, tc = read_counts(counters)

    done = [r for r in reqs if r.finish_time >= 0 and not r.error]
    if len(done) != len(reqs):
        raise AssertionError(f"served {len(done)}/{len(reqs)} requests")
    for r in reqs:
        if len(r.output_tokens) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"request {r.req_id}: bad token stream")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched while "
                                 "serving")
    check_routes("serve", launches, tc, ("moe_gmm_ragged", "paged_decode"))
    K = cfg.moe.top_k
    for e, (B, A) in zip(engines, stats):
        routed = e.total_prefill_tokens + e.total_decode_tokens
        if B.shape != (cfg.n_moe_layers, cfg.moe.n_experts) or \
                not (B.sum(axis=1) == routed * K).all():
            raise AssertionError(f"engine {e.engine_id}: B does not count "
                                 f"{routed} routed tokens x top-{K}")
        if not np.array_equal(A.sum(axis=1), B) or \
                A[:, 1 - e.engine_id].any():
            raise AssertionError(f"engine {e.engine_id}: A is not "
                                 "consistent with B and the engine's source")
    prompt = sum(r.prompt_len for r in reqs)
    gen_tok = sum(len(r.output_tokens) for r in reqs)
    log(f"serve: {len(done)}/{len(reqs)} requests finished at full width "
        f"({cfg.n_layers} layers), {prompt} prompt + {gen_tok} generated "
        f"tokens in {wall:.2f} s: {gen_tok / wall:.1f} generated tokens/s, "
        f"{(prompt + gen_tok) / wall:.1f} tokens/s processed, "
        f"{len(steps)} engine steps, mean step {np.mean(steps) * 1e3:.1f} ms, "
        f"on {torch.cuda.get_device_name(0)}")
    log(f"serve: B per layer = routed tokens x top-{K} and A summed over "
        f"sources = B on both engines; launches {launches}, on the tensor "
        f"cores {tc}")

    # full-width logits straight from an entry point: finite, right shape
    pages = tfm.init_paged_cache(cfg, 9, 16, device="cuda")
    toks = torch.as_tensor([reqs[0].prompt_tokens[:100]], device="cuda")
    batch = {"tokens": toks.to(torch.int32),
             "chunk_starts": torch.zeros(1, dtype=torch.int32, device="cuda"),
             "chunk_lens": torch.full((1,), 100, dtype=torch.int32,
                                      device="cuda")}
    bt = torch.arange(1, 9, dtype=torch.int32, device="cuda")[None]
    logits, _, _ = tfm.prefill_chunk_paged(
        params, cfg, batch, pages, block_tables=bt,
        source_ids=torch.zeros(1, dtype=torch.int32, device="cuda"),
        n_sources=2)
    if tuple(logits.shape) != (1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError("full-width prefill logits not finite or of "
                             "the wrong shape")
    log(f"logits: prefill of 100 tokens gives finite f32 logits of shape "
        f"{tuple(logits.shape)}")

    def again():
        _, steps, _, _ = serve(cfg, params, ecfg, make_requests(
            cfg, 8, 100, 900, new_tokens, seed=args.seed))
        return f"{len(steps)} engine steps"

    profiled("serve", again)
    return launches, tc, cfg, params


def cluster_phase(args, cfg, params, counters):
    """16 requests arriving over time through serve_real_cluster on two
    engines with int8 KV pages, under the Gimbal scheduler and an
    uncalibrated placement whose small window makes experts migrate."""
    from repro_torch.core import PlacementConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import PagedEngineConfig
    ecfg = PagedEngineConfig(page_size=16, n_pages=512,
                             max_blocks_per_req=64, max_batch=8,
                             token_budget=512,
                             chunk_buckets=(64, 128, 256, 512),
                             kv_dtype="int8", device="cuda")
    new_tokens = 32
    reqs = make_requests(cfg, 16, 100, 900, new_tokens, seed=args.seed + 1,
                         gap=0.1)
    # time each adoption of a placement: serve_real_cluster moves the
    # experts' weights through this function, once per shared runner
    moves = []
    migrate = timed_migrations(tfm, moves)
    reset_counts(counters)
    try:
        res, engines, wall = serve_cluster(
            cfg, params, ecfg, reqs, window_tokens=1024,
            placement_cfg=PlacementConfig.uncalibrated())
    finally:
        tfm.migrate_params_for_placement = migrate
    launches, tc = read_counts(counters)

    sig = res.signals
    bad = [r.req_id for r in reqs if r.error or r.finish_time < 0
           or len(r.full_output_tokens) != new_tokens
           or not all(0 <= t < cfg.vocab_size for t in r.full_output_tokens)]
    if bad or sig["unfinished"]:
        raise AssertionError(f"cluster: requests {bad} did not finish with a "
                             f"full in-vocabulary stream ({sig['errors']})")
    if sig["migrations"] <= 0 or not moves:
        raise AssertionError("cluster: no placement was adopted, so no "
                             "expert weights moved on the card")
    if min(sig["per_engine"].values()) <= 0:
        raise AssertionError(f"cluster: an engine served nothing "
                             f"({sig['per_engine']})")
    for name, n in launches.items():
        if n <= 1:
            raise AssertionError(f"cluster: kernel {name} launched {n} "
                                 "times")
    check_routes("cluster", launches, tc,
                 ("moe_gmm_ragged", "paged_decode"))
    prompt = sum(r.prompt_len for r in reqs)
    gen_tok = sum(len(r.full_output_tokens) for r in reqs)
    fp = tfm.paged_cache_page_nbytes(
        tfm.init_paged_cache(cfg, 2, ecfg.page_size, device="meta"))
    i8 = tfm.paged_cache_page_nbytes(
        tfm.init_paged_cache(cfg, 2, ecfg.page_size, kv_dtype="int8",
                             device="meta"))
    log(f"cluster: {len(reqs)}/{len(reqs)} requests arriving over "
        f"{reqs[-1].arrival_time:.1f} virtual s served through "
        f"serve_real_cluster on 2 engines with int8 KV pages at full width "
        f"({cfg.n_layers} layers): {sig['rounds']} rounds, {prompt} prompt + "
        f"{gen_tok} generated tokens in {wall:.2f} s wall, "
        f"{gen_tok / wall:.1f} generated tokens/s, "
        f"{(prompt + gen_tok) / wall:.1f} tokens/s processed, on "
        f"{torch.cuda.get_device_name(0)}")
    log(f"cluster: decisions {sig['decisions']}, per engine "
        f"{sig['per_engine']}, {sig['migrations']} placements adopted "
        f"({sig['expert_moves']} expert moves), apply_placement wall ms "
        f"{[round(t * 1e3, 1) for t in moves]}, kv_peak {sig['kv_peak']:.4f}")
    log(f"cluster: int8 pool holds {fp / i8:.4f}x the tokens per byte of "
        f"the bf16 pool ({i8} against {fp} bytes per page across "
        f"{cfg.n_layers} layers); launches {launches}, on the tensor cores "
        f"{tc}")
    del res, engines               # the runner's migrated weights: 10.5 GiB

    forwards = [0]

    def again():
        res, _, _ = serve_cluster(
            cfg, params, ecfg, make_requests(cfg, 16, 100, 900, new_tokens,
                                             seed=args.seed + 1, gap=0.1),
            window_tokens=1024, placement_cfg=PlacementConfig.uncalibrated())
        return f"{res.signals['rounds']} rounds, {forwards[0]} forward passes"

    restore = counted_forwards(tfm, forwards)
    try:
        rows, _ = profiled("cluster", again)
    finally:
        restore()
    profile_write_and_stats(rows, forwards[0] * cfg.n_layers,
                            forwards[0] * cfg.n_moe_layers)
    return launches, tc


def profile_write_and_stats(rows, layer_steps, moe_steps):
    """From the profiled int8 cluster serve: the int8 KV write is one
    kernel per layer-step, and the statistics one single-block kernel per
    MoE layer-step, with no memset of their own (the grid path's two). The
    profiler now and then drops an event, so a count may fall short of the
    steps by 1% (two launches a step would double it)."""
    def count(name):
        return sum(n for _, n, key in rows if name in key)

    def one_each(n, steps):
        return steps - steps // 100 <= n <= steps

    writes, blocks = count("::pack_kv_kernel"), count(
        "source_expert_count_block")
    grids = count("source_expert_count_grid")
    if not one_each(writes, layer_steps) or not one_each(blocks, moe_steps) \
            or grids:
        raise AssertionError(f"profile cluster: expected one int8 write "
                             f"kernel per layer-step ({layer_steps}) and one "
                             f"single-block stats kernel per MoE layer-step "
                             f"({moe_steps}), saw {writes} writes, {blocks} "
                             f"single-block and {grids} grid stats kernels")
    n_kernels = sum(n for _, n, key in rows if "emset" not in key)
    memsets = sum(n for _, n, key in rows if "emset" in key)
    log(f"profile cluster: {layer_steps} layer-steps: {writes} int8 KV write "
        f"kernels (one per layer-step), {blocks} stats kernels on one block "
        f"(one per MoE layer-step, no memset); {n_kernels} device kernels "
        f"and {memsets} memsets in all, {n_kernels / layer_steps:.1f} kernels "
        f"per layer-step")


def timed_migrations(tfm, moves):
    """Wrap tfm.migrate_params_for_placement (through which
    serve_real_cluster moves the experts' weights) to time each call into
    ``moves``; returns the original to restore."""
    migrate = tfm.migrate_params_for_placement

    def timed_migrate(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = migrate(*a, **kw)
        torch.cuda.synchronize()
        moves.append(time.perf_counter() - t0)
        return out

    tfm.migrate_params_for_placement = timed_migrate
    return migrate


def dense_cluster_phase(args, cfg, params, counters):
    """16 requests arriving over time through serve_real_cluster on two
    dense-cache RealModelEngines with the capacity-padded MoE dispatch,
    under the Gimbal scheduler and an uncalibrated placement whose small
    window makes experts migrate (each engine moves its own weights)."""
    from repro_torch.core import PlacementConfig
    from repro_torch.models import transformer as tfm
    max_slots, max_len, new_tokens = 8, 1024, 32
    reqs = make_requests(cfg, 16, 100, 900, new_tokens, seed=args.seed + 2,
                         gap=0.1)
    moves = []
    migrate = timed_migrations(tfm, moves)
    reset_counts(counters)
    try:
        res, engines, wall, kv_peak = serve_dense_cluster(
            cfg, params, reqs, device="cuda", ragged=False,
            max_slots=max_slots, max_len=max_len, window_tokens=1024,
            placement_cfg=PlacementConfig.uncalibrated())
    finally:
        tfm.migrate_params_for_placement = migrate
    launches, tc = read_counts(counters)

    sig = res.signals
    bad = [r.req_id for r in reqs if r.error or r.finish_time < 0
           or len(r.full_output_tokens) != new_tokens
           or not all(0 <= t < cfg.vocab_size for t in r.full_output_tokens)]
    if bad or sig["unfinished"]:
        raise AssertionError(f"dense cluster: requests {bad} did not finish "
                             f"with a full in-vocabulary stream "
                             f"({sig['errors']})")
    if sig["migrations"] <= 0 or not moves:
        raise AssertionError("dense cluster: no placement was adopted, so no "
                             "expert weights moved on the card")
    if min(sig["per_engine"].values()) <= 0:
        raise AssertionError(f"dense cluster: an engine served nothing "
                             f"({sig['per_engine']})")
    for name in ("flash_decode", "moe_gmm"):
        if launches[name] <= 1:
            raise AssertionError(f"dense cluster: kernel {name} launched "
                                 f"{launches[name]} times")
    check_routes("dense cluster", launches, tc, ("moe_gmm", "flash_decode"))
    steps = sum(e.step_count for e in engines)
    prompt = sum(r.prompt_len for r in reqs)
    gen_tok = sum(len(r.full_output_tokens) for r in reqs)
    cache_mib = sum(t.numel() * t.element_size() for e in engines
                    for c in e.cache.values() for t in c.values()) / 2**20
    log(f"dense cluster: {len(reqs)}/{len(reqs)} requests arriving over "
        f"{reqs[-1].arrival_time:.1f} virtual s served through "
        f"serve_real_cluster on 2 dense-cache RealModelEngines ({max_slots} "
        f"slots x {max_len} tokens, padded MoE dispatch) at full width "
        f"({cfg.n_layers} layers): {sig['rounds']} rounds, {steps} decode "
        f"steps, {prompt} prompt + {gen_tok} generated tokens in {wall:.2f} "
        f"s wall, {gen_tok / wall:.1f} generated tokens/s, "
        f"{(prompt + gen_tok) / wall:.1f} tokens/s processed, on "
        f"{torch.cuda.get_device_name(0)}")
    log(f"dense cluster: decisions {sig['decisions']}, per engine "
        f"{sig['per_engine']}, {sig['migrations']} placements adopted "
        f"({sig['expert_moves']} expert moves), migrate wall ms "
        f"{[round(t * 1e3, 1) for t in moves]}, kv_peak {kv_peak:.4f} "
        f"(peak token occupancy of the dense caches in the engines' traces; "
        f"the cluster's own kv_peak reads page pools: "
        f"{sig['kv_peak']:.4f}), dense caches {cache_mib:.1f} MiB in all; "
        f"launches {launches}, on the tensor cores {tc}")
    del res, engines               # their migrated weights: 2 x 10.5 GiB

    def again():
        again_reqs = make_requests(cfg, 16, 100, 900, new_tokens,
                                   seed=args.seed + 2, gap=0.1)
        res, engines, _, _ = serve_dense_cluster(
            cfg, params, again_reqs, device="cuda", ragged=False,
            max_slots=max_slots, max_len=max_len, window_tokens=1024,
            placement_cfg=PlacementConfig.uncalibrated())
        return (f"{res.signals['rounds']} rounds, "
                f"{sum(e.step_count for e in engines)} decode steps")

    profiled("dense cluster", again)
    return launches, tc


# ---------------------------------------------------------------- scenarios
def scenario_ecfg(device, **kw):
    """Full-width scenario engines: bf16 pages of 16 tokens, 64 a request
    (the slices' prompts stay under 1008 tokens), prefix sharing and mixed
    steps on."""
    from repro_torch.serving import PagedEngineConfig
    base = dict(page_size=16, n_pages=1024, max_blocks_per_req=64,
                max_batch=8, token_budget=512,
                chunk_buckets=(64, 128, 256, 512), prefix_sharing=True,
                mixed_steps=True, device=device)
    return PagedEngineConfig(**dict(base, **kw))


def max_prompt(ecfg) -> int:
    return ecfg.max_blocks_per_req * ecfg.page_size - 16


def record_dispatch_and_windows(engines, first, windows):
    """Wrap each engine to record every request's first dispatch time into
    ``first`` and, if ``windows`` is a list, each (B, A) window the engine
    hands the coordinator into it."""
    for e in engines:
        def enqueue(r, now, _enqueue=e.enqueue):
            first.setdefault(r.req_id, now)
            _enqueue(r, now)
        e.enqueue = enqueue
        if windows is not None:
            def window_stats(_window_stats=e.window_stats):
                stats = _window_stats()
                if stats[0] is not None:
                    windows.append(stats)
                return stats
            e.window_stats = window_stats


def serve_slice(cfg, params, ecfg, reqs, *, pool=None, tier=False,
                windows=None, **cluster_kw):
    """``reqs`` through ``serve_real_cluster`` on two engines sharing one
    runner, with streaming metrics, and the scenario invariant pack held on
    the run. ``pool``: pages per engine over the runner's arrays (a tight
    pool); ``tier``: the engines share a ``HostKVTier`` and preempt by
    swapping to it; ``windows``: a list that collects the engines' (B, A)
    windows. Returns (SimResult, engines, the pack's aggregates,
    metrics, wall s, requests dispatched again, each recovered off a
    crashed engine)."""
    import dataclasses
    from repro_torch.core import StreamingMetrics
    from repro_torch.serving import (HostKVTier, PagedModelRunner,
                                     PagedRealEngine, RealClusterConfig,
                                     serve_real_cluster)
    from repro_torch.workloads import check_scenario_invariants
    runner = PagedModelRunner(cfg, params, ecfg, n_sources=2)
    eng_cfg = ecfg
    if pool is not None:
        eng_cfg = dataclasses.replace(eng_cfg, n_pages=pool)
    host = None
    if tier:
        host = HostKVTier()
        eng_cfg = dataclasses.replace(eng_cfg, swap_policy="swap")
    engines = [PagedRealEngine(i, cfg, params, eng_cfg, runner=runner,
                               n_sources=2, tier=host) for i in range(2)]
    first = {}
    record_dispatch_and_windows(engines, first, windows)
    metrics = StreamingMetrics(window_s=10.0, seed=0)
    t0 = time.perf_counter()
    res = serve_real_cluster(reqs, engines, metrics=metrics,
                             cluster_cfg=RealClusterConfig(**cluster_kw))
    if ecfg.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a request recovered off a crashed engine is dispatched again, which
    # overwrites its dispatch_time, but keeps the first_token_time its
    # client saw before the crash (both packages do this); the pack orders
    # arrival <= dispatch <= first token, which holds for the first dispatch.
    # Only recovery may dispatch a request twice: none without a fault plan
    redispatched = [r.req_id for r in reqs
                    if r.dispatch_time != first[r.req_id]]
    allowed = (res.signals["recovered_requests"] if "fault_plan" in cluster_kw
               else 0)
    if len(redispatched) > allowed:
        raise AssertionError(f"{len(redispatched)} requests dispatched again "
                             f"after their first dispatch, {allowed} "
                             f"recovered: {redispatched}")
    for r in reqs:
        r.dispatch_time = first[r.req_id]
    inv = check_scenario_invariants(reqs, res, engines=engines,
                                    metrics=metrics)
    return res, engines, inv, metrics, wall, redispatched


def slice_line(label, reqs, res, inv, metrics, wall):
    lat = metrics.snapshot()["metrics"]
    q = lambda k, p: lat.get(k, {}).get(p, float("nan"))  # noqa: E731
    log(f"{label}: {len(reqs)} requests, {res.signals['rounds']} rounds, "
        f"{wall:.2f} s wall, TTFT p50 {q('ttft', 'p50'):.3f} p99 "
        f"{q('ttft', 'p99'):.3f} s, TPOT p50 {q('tpot', 'p50'):.4f} p99 "
        f"{q('tpot', 'p99'):.4f} s (virtual time), hit rate "
        f"{inv['hit_rate']:.4f}, {inv['prefix_hit_tokens']} prefix-hit "
        f"tokens, decisions {res.signals['decisions']}, preemptions "
        f"{res.signals['preemptions']}, migrations "
        f"{res.signals['migrations']}")


def queue_c_serve(cfg, params, ecfg, pool, n, seed, label, windows=None):
    """The session slice with every Queue C path on: a tight pool of
    ``pool`` pages an engine and short prefill chunks, so that prefill growth
    preempts; preemption by swapping to a shared host tier; predictive
    placement with staged prefetch, uncalibrated so that experts migrate;
    engine 1 crashing at round 20 and rejoining at round 40. Every request
    must finish, none lost or errored, with preemptions, swaps, recovered
    requests and staged-prefetch adoptions all above zero. Returns
    (requests, SimResult)."""
    from repro_torch.core import PlacementConfig
    from repro_torch.ft import FaultEvent, FaultPlan, HealthConfig
    from repro_torch.workloads import SCENARIOS, build_real_slice
    reqs = build_real_slice(SCENARIOS["agentic_sessions"], n, seed=seed,
                            vocab=cfg.vocab_size, max_prompt=max_prompt(ecfg),
                            rps=48.0)
    res, engines, inv, metrics, wall, redisp = serve_slice(
        cfg, params, ecfg, reqs, pool=pool, tier=True, windows=windows,
        window_tokens=ecfg.page_size * 25, prefetch=True, predictive=True,
        placement_cfg=PlacementConfig.uncalibrated(),
        health_cfg=HealthConfig(trace_timeout_s=0.3),
        fault_plan=FaultPlan(events=(FaultEvent("crash", 1, 20),
                                     FaultEvent("recover", 1, 40))))
    sig = res.signals
    lost = [r.req_id for r in reqs if r.error or r.finish_time < 0]
    counts = {k: sig[k] for k in ("preemptions", "swapped_out_reqs",
                                  "swapped_in_reqs", "recovered_requests",
                                  "prefetch_pointer_swaps", "migrations")}
    events = [(e["engine"], e["event"]) for e in sig["health_events"]]
    if lost or sig["unfinished"] or sig["errors"] or \
            min(counts.values()) <= 0 or (1, "rejoin") not in events:
        raise AssertionError(f"{label}: expected every request finished and "
                             f"every Queue C path taken, got lost {lost}, "
                             f"unfinished {sig['unfinished']}, errors "
                             f"{sig['errors']}, {counts}, health events "
                             f"{events}")
    slice_line(label, reqs, res, inv, metrics, wall)
    # the cluster's swapped_tokens is what the tier still holds at the end
    # (0 once every swapped request came back): the swaps are counted by
    # the allocators' swapped_out_reqs and swapped_in_reqs
    log(f"{label}: {counts}, {sig['swap_out_bytes']} bytes to the host tier "
        f"and {sig['swap_in_bytes']} back, {sig['cow_copies']} copy-on-write "
        f"pages, health events {events}, "
        f"{len(redisp)} requests dispatched again after the crash "
        f"(the pack held on their first dispatch), invariant pack green")
    return reqs, res


def queue_c_reference(cfg, params, params_gpu):
    """Queue C's serve on the float32 twin, card against CPU: the same
    token streams, (B, A) windows, prefix hits, copy-on-write copies,
    preemptions, swaps, recovered requests and migrations."""
    keys = ("prefix_hit_tokens", "cow_copies", "preemptions",
            "swapped_out_reqs", "swapped_in_reqs", "recovered_requests",
            "migrations", "expert_moves", "decisions")
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        ecfg = scenario_ecfg(dev, page_size=8, n_pages=48,
                             max_blocks_per_req=8, max_batch=4,
                             token_budget=8, chunk_buckets=(8,))
        windows = []
        reqs, res = queue_c_serve(cfg, p, ecfg, 8, 24, 0,
                                  f"float32 twin Queue C serve ({dev})",
                                  windows)
        out[dev] = ([r.full_output_tokens for r in reqs],
                    {k: res.signals[k] for k in keys}, windows)
    (toks_c, sig_c, win_c), (toks_g, sig_g, win_g) = out["cpu"], out["cuda"]
    same_windows = len(win_c) == len(win_g) and all(
        np.array_equal(a, b) for wc, wg in zip(win_c, win_g)
        for a, b in zip(wc, wg))
    if toks_c != toks_g or sig_c != sig_g or not same_windows:
        diff = [k for k in keys if sig_c[k] != sig_g[k]]
        raise AssertionError(f"float32 twin Queue C serve: card and CPU "
                             f"disagree (tokens equal: {toks_c == toks_g}, "
                             f"(B, A) windows equal: {same_windows}, "
                             f"signals that differ: {diff})")
    log(f"reference: float32 twin Queue C serve (session slice, tight pool, "
        f"swap to host, predictive prefetch, crash and recovery, prefix "
        f"sharing, mixed steps): card kernels and CPU plain versions give "
        f"the same {sum(map(len, toks_c))} tokens and {len(win_c)} (B, A) "
        f"windows, {sig_g}")


def gate_serves(cfg, params, ecfg, seed, feedback):
    """The reference's sim<->real gate at full width: the same session
    slice (assistant turns not folded, arrivals 3 virtual s apart, so each
    turn finds the previous one finished and registered) served on the
    card and by ``simulate``, with the MoE-pressure feedback into dispatch
    on or off on both planes. Returns, per plane, the finished requests,
    prefix-hit tokens, hit rate and decision counts, and the card's wall s
    and rounds."""
    from repro_torch.core import SchedulerConfig, StreamingMetrics
    from repro_torch.serving import EngineConfig, SystemConfig, simulate
    from repro_torch.workloads import (SCENARIOS, build_real_slice,
                                       check_scenario_invariants)

    def mk():
        reqs = build_real_slice(SCENARIOS["agentic_sessions"], 10, seed=seed,
                                vocab=cfg.vocab_size,
                                max_prompt=max_prompt(ecfg), rps=0.25,
                                fold_assistant=False)
        for i, r in enumerate(reqs):
            r.arrival_time = 3.0 * (i + 1)
        return reqs

    real = mk()
    rres, _, rinv, _, wall, _ = serve_slice(
        cfg, params, ecfg, real, window_tokens=200,
        scheduler_cfg=SchedulerConfig(), feedback=feedback)
    sim = mk()
    smetrics = StreamingMetrics(window_s=5.0, seed=0)
    sres = simulate(sim, SystemConfig(name="diff_sim", n_engines=2,
                                      n_moe_layers=4, n_experts=16, top_k=2,
                                      feedback=feedback),
                    engine_cfg=EngineConfig(
                        kv_tokens=ecfg.n_pages * ecfg.page_size,
                        kv_block=ecfg.page_size, prefix_sharing=True),
                    traffic_seed=0, metrics=smetrics)
    sinv = check_scenario_invariants(sim, sres, engines=sres.engines,
                                     metrics=smetrics)
    plane = lambda reqs, res, inv: {  # noqa: E731
        "finished": sorted(r.req_id for r in reqs if r.finish_time >= 0),
        "prefix_hit_tokens": inv["prefix_hit_tokens"],
        "hit_rate": inv["hit_rate"],
        "decisions": dict(res.signals["decisions"])}
    return (plane(real, rres, rinv), plane(sim, sres, sinv), wall,
            rres.signals["rounds"])


def sim_real_gate(cfg, params, ecfg, seed):
    """The gate twice. With the MoE-pressure feedback on, as the reference
    runs it, both planes must finish every turn with the same prefix-hit
    tokens (> 0) and hit rate; their decision counts are printed, not
    compared: the feedback comes from the real router on the card and from
    the synthetic routing model in ``simulate``, and at full width it moves
    the card's choices off the affinity path. With the feedback off on both
    planes, the reference's whole gate: the same finish sets, prefix-hit
    tokens (> 0), hit rate and affinity decisions (> 0)."""
    for feedback in (True, False):
        real, sim, wall, rounds = gate_serves(cfg, params, ecfg, seed,
                                              feedback)
        raff = real["decisions"].get("affinity_path", 0)
        saff = sim["decisions"].get("affinity_path", 0)
        same = (real["finished"] == sim["finished"] == list(range(10))
                and real["prefix_hit_tokens"] == sim["prefix_hit_tokens"] > 0
                and abs(real["hit_rate"] - sim["hit_rate"])
                <= 1e-6 * sim["hit_rate"])
        if not same or not (feedback or raff == saff > 0):
            raise AssertionError(f"sim<->real gate (feedback "
                                 f"{'on' if feedback else 'off'}): card "
                                 f"{real}, simulate {sim}")
        log(f"scenario: sim<->real gate at full width, feedback "
            f"{'on' if feedback else 'off'}: {len(real['finished'])} session "
            f"turns in {wall:.2f} s wall ({rounds} rounds) finish the same "
            f"set on the card and in simulate, {real['prefix_hit_tokens']} "
            f"prefix-hit tokens, hit rate {real['hit_rate']:.4f} on both "
            f"planes; affinity decisions card {raff}, simulate {saff} "
            f"(card {real['decisions']}, simulate {sim['decisions']})")


def scenario_phase(args, cfg, params, counters):
    """The scenario slices at full width on bf16 fp pages with prefix
    sharing and mixed steps, the sim<->real gate, the Queue C paths in one
    serve, the serving CLI and the paged example's modes."""
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.examples import serve_moe_paged
    from repro_torch.workloads import SCENARIOS, build_real_slice
    ecfg = scenario_ecfg("cuda")
    hits, launches, tc = {}, {}, {}
    for name, n in (("agentic_sessions", 32), ("chat_oneshot", 24)):
        reqs = build_real_slice(SCENARIOS[name], n, seed=args.seed,
                                vocab=cfg.vocab_size,
                                max_prompt=max_prompt(ecfg), rps=4.0)
        got = {}

        def run():
            res, _, inv, metrics, wall, _ = serve_slice(
                cfg, params, ecfg, reqs, window_tokens=250)
            got.update(res=res, inv=inv, metrics=metrics, wall=wall)
            return f"{name}: {res.signals['rounds']} rounds"

        label = f"scenario {name}"
        reset_counts(counters)
        if name == "agentic_sessions":
            profiled(label, run)
            label += " (profiled)"
        else:
            run()
        launches[name], tc[name] = read_counts(counters)
        for k in ("paged_decode", "moe_gmm_ragged", "source_expert_count"):
            if launches[name][k] <= 1:
                raise AssertionError(f"scenario {name}: kernel {k} launched "
                                     f"{launches[name][k]} times")
        check_routes(f"scenario {name}", launches[name], tc[name],
                     ("moe_gmm_ragged", "paged_decode"))
        slice_line(label, reqs, got["res"], got["inv"], got["metrics"],
                   got["wall"])
        hits[name] = got["inv"]["hit_rate"]
    if not hits["agentic_sessions"] > hits["chat_oneshot"]:
        raise AssertionError(f"scenario: the session slice must out-hit the "
                             f"one-shot slice, got {hits}")
    log(f"scenario: launches of the session slice "
        f"{launches['agentic_sessions']}, on the tensor cores "
        f"{tc['agentic_sessions']}; hit rates {hits}")

    sim_real_gate(cfg, params, ecfg, args.seed)

    torch.cuda.reset_peak_memory_stats()
    queue_c_serve(cfg, params, scenario_ecfg("cuda", n_pages=256,
                                             token_budget=128,
                                             chunk_buckets=(64, 128)),
                  34, 32, args.seed, "scenario Queue C serve (bf16, full "
                  "width)")
    log(f"scenario Queue C serve: peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(the weights, the migrated tree, the prefetch's staged copy and "
        f"a migration's transient copy of the expert stacks)")

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    for flags in (("--real", "--paged"), ("--real",)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                              *flags], env=env, cwd=HERE, capture_output=True,
                             text=True, timeout=600)
        served = [ln for ln in out.stdout.splitlines() if "served" in ln]
        if out.returncode or not any("served 12/12" in ln for ln in served):
            raise AssertionError(f"launch.serve {' '.join(flags)}: exit "
                                 f"{out.returncode}\n{out.stdout[-2000:]}\n"
                                 f"{out.stderr[-4000:]}")
        log(f"cli: python -m repro_torch.launch.serve {' '.join(flags)} on "
            f"the card: exit 0 in {time.perf_counter() - t0:.1f} s, "
            f"{served[0]}")
    twin = reduced(get_smoke_config("qwen3-moe-30b-a3b"), dtype="float32")
    for mode in ("shared_prefix", "chaos"):
        serve_moe_paged.main(**{mode: True}, device="cuda", cfg=twin)
        log(f"example: serve_moe_paged.main({mode}=True) on the float32 twin "
            f"on the card: its bit-identity asserts hold")
    return launches["agentic_sessions"], tc["agentic_sessions"]


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.kv_pack import pack_kv, unpack_kv
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ragged
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.source_expert_count import source_expert_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t_build = ops.build()
    log(f"build: {len(ops.KERNELS)} CUDA sources with nvcc in "
        f"{t_build:.1f} s")
    for name, text in ops.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    t_phase = [time.perf_counter()]

    def phase_done(name):
        t_phase.append(time.perf_counter())
        log(f"time: {name} phase took {t_phase[-1] - t_phase[-2]:.1f} s")

    results = kernel_phase()
    phase_done("kernel")
    reference_phase()
    phase_done("reference")
    counters = {"paged_decode": paged_decode,
                "moe_gmm_ragged": moe_gmm_ragged,
                "source_expert_count": source_expert_count}
    serve_launches, serve_tc, cfg, params = serve_phase(args, counters)
    phase_done("serve (with its profiled rerun)")
    counters.update(pack_kv=pack_kv, unpack_kv=unpack_kv)
    launches, cluster_tc = cluster_phase(args, cfg, params, counters)
    phase_done("cluster")
    counters.update(flash_decode=flash_decode, moe_gmm=moe_gmm)
    dense_launches, dense_tc = dense_cluster_phase(args, cfg, params,
                                                   counters)
    phase_done("dense cluster (with its profiled rerun)")
    scen_launches, scen_tc = scenario_phase(args, cfg, params, counters)
    phase_done("scenario")
    # each kernel's main-path count: the dense cluster serve for the two
    # kernels of the dense plane, the paged cluster serve for the others
    main_launches = dict(launches, flash_decode=dense_launches["flash_decode"],
                         moe_gmm=dense_launches["moe_gmm"])
    main_tc = dict(cluster_tc, moe_gmm=dense_tc["moe_gmm"],
                   flash_decode=dense_tc["flash_decode"])

    meta = {
        "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                         "src/repro/kernels/paged_decode.py:35"),
        "moe_gmm_ragged": ("src/repro_torch/csrc/moe_gmm.cu",
                           "src/repro/kernels/moe_gmm.py:82"),
        "source_expert_count": ("src/repro_torch/csrc/source_expert_count.cu",
                                "src/repro/kernels/source_expert_count.py:24"),
        "pack_kv": ("src/repro_torch/csrc/kv_pack.cu",
                    "src/repro/kernels/kv_pack.py:38"),
        "unpack_kv": ("src/repro_torch/csrc/kv_pack.cu",
                      "src/repro/kernels/kv_pack.py:45"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:22"),
        "moe_gmm": ("src/repro_torch/csrc/moe_gmm.cu",
                    "src/repro/kernels/moe_gmm.py:34"),
    }
    kernels = []
    for name, rows in results.items():
        main_row = rows[0][1]          # bf16 at the first serving shape
        route_key = "gmm_route" if "gmm" in name else "decode_route"
        routes = {}
        if name in main_tc:            # the GEMMs' and decode kernels' routes
            routes = {"tc_launches": main_tc[name],
                   "tc_launches_by_path": {
                       "serve": serve_tc.get(name, 0),
                       "cluster_serve": cluster_tc.get(name, 0),
                       "dense_cluster_serve": dense_tc[name],
                       "scenario_serve": scen_tc.get(name, 0)}}
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": main_launches[name],
            "launches_by_path": {"serve": serve_launches.get(name, 0),
                                 "cluster_serve": launches.get(name, 0),
                                 "dense_cluster_serve": dense_launches[name],
                                 "scenario_serve": scen_launches.get(name, 0)},
            "max_abs_err": max(r["err"] for dt, r in rows
                               if dt.split("/")[0] in ("bfloat16", "int32")),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound"][0],
            "bound_by": main_row["bound"][1],
            "library_ms": main_row["library_ms"],
            "device_ms": main_row["device_ms"],
            **({"library_device_ms": main_row["library_device_ms"]}
               if "library_device_ms" in main_row else {}),
            "shape": main_row["shape"], **routes,
            "shapes": [{"dtype": dt, "shape": r["shape"], "err": r["err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"],
                        **{k: r[k] for k in ("row_rel_err", "device_ms",
                                             "device_parts",
                                             "library_device_ms")
                           if k in r},
                        **({route_key: r["route"]} if "route" in r else {})}
                       for dt, r in rows],
        })
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
