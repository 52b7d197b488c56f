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
9. frees the Qwen3 weights and serves llama4-maverick at full width (d
   5120, 40/8 heads, vocab 202048, 128 experts top-1 of 8192 and a shared
   expert, a dense FFN of 16384), depth cut 48 -> 2 (one period, 34.79 GiB
   of bf16 weights): first its MoE layer against an f32 computation on the
   card, then 16 requests of 128 to 1024 prompt tokens through
   ``serve_real_cluster`` on two engines with int8 pages and experts
   migrating, profiled; it prints the card's memory after init and the
   serve's peak, and each adoption's wall time, bytes moved and peak rise,
   and fails if no placement was adopted, if an adoption's peak rise
   passed the moved experts' bytes plus 64 MiB, if the caller's weights
   changed, or if the profile lacks one int8 write per layer-step. The
   kernel phase holds the five paged-path kernels at llama4's shapes too
   (decode at G = 5, the GEMMs at 5120 <-> 8192, top-1), and the reference
   phase llama4's float32 twin through ``serve_real_cluster`` card against
   CPU, with uncalibrated and with predictive placement and staged
   prefetch;
10. the ``dense_families`` phase, each family's weights freed before the
   next: qwen3-8b at full width and depth (36 layers) through
   ``serve_real_cluster`` over two paged engines on bf16 pages, on int8
   pages, and over two dense engines (8 requests of 256 to 1024 prompt
   tokens, 32 new each); gemma3-12b (48 layers, 5 local layers of window
   1024 to 1 global, hd 256) and gemma2-2b (26 layers, softcaps 50 and 30,
   hd 256) over two dense engines of 2048 tokens a slot (prompts of 900 to
   1400 tokens that overflow gemma3's 1024-slot rings, 64 new), where
   ``flash_decode`` takes the CUDA cores (2 of gemma3's requests, 16 new
   tokens each, are served again under the profiler); qwen1.5-32b at full
   width and 32
   of its 64 layers through ``build_model``'s entry points (8 prompts of
   1024 tokens, 32 decode steps) with a bf16 and an int8 cache, whose
   logits must meet the reference's int8 bar, then over two dense engines;
   and the four families' float32 twins, card against CPU, over dense
   engines and, for the two qwens, int8 pages. Each serve prints its
   Algorithm-1 decisions, launches, routes and peak memory. The kernel
   phase holds ``paged_decode`` at G = 4 and G = 1, ``flash_decode`` with
   a window and a softcap, at hd 256 and on int8 caches, and the dense
   int8 write at these families' shapes;
11. the ``other_families`` phase, each family's weights freed before the
   next, through ``build_model``'s entry points: llava-next-34b at full
   width and 30 of its 60 layers (prefill of 4 x 2880 stand-in patch
   embeddings, 32 decode steps, with a bf16 and an int8 cache held to each
   other at the reference's int8 bar, and a decode held to a prefill one
   row longer at the same bar; then 8 token requests over two dense
   engines, ``flash_decode`` at G = 7 on the tensor cores); hymba-1.5b
   full (32 layers, attention and a mamba branch in each, 30 local layers
   with 1024-slot rings: 8 requests of 900 to 1400 prompt tokens over two
   dense engines, ``flash_decode`` at G = 5 on the tensor cores; a decode
   after 1199 tokens against a prefill of 1200; the wall time of one
   1400-token prefill and of its mamba loop); xlstm-125m full (a decode
   after 511 tokens against a prefill of 512; the count of state leaves
   the dense engine splices, 0, as in the reference; 8 requests over two
   dense engines); seamless-m4t-large-v2 full (24 + 24 layers: 1024
   stand-in frames, a 32-token prompt, 32 decode steps with
   ``enc_lengths``, a decode against a prefill one token longer); and
   the four float32 twins card against CPU (entry points within 1e-4;
   the three served families' cluster serves with the same tokens and
   decisions). The kernel phase holds ``flash_decode`` at hymba's and
   llava's shapes (a window of 1024 over 4096 slots; int8) and the dense
   int8 write at llava's 8 KV heads;
12. the ``train`` phase, the earlier phases' weights freed first:
   qwen3-moe-30b-a3b at full width and ``--layers`` of its 48 layers
   trained through ``build_model(cfg).loss`` and ``make_train_step`` on
   one fixed batch of 4 x 512 tokens from ``--seed`` (lr 1e-3, bf16 params
   and moments): 4 steps on the ragged path (the expert GEMMs' forward,
   its recompute in the backward and dx on the tensor cores; dw in
   PyTorch ops, as the reference computes it) and a fifth under the
   profiler, 2 on the padded path from the same init (``moe_gmm`` for the
   forward, dx and dw), one with int8 moments and int8 gradient
   compression;
   every loss finite, the loss falling on the
   repeated batch, each step's wall and peak memory printed with the
   bytes of params, grads and moments, the launches held to their exact
   counts and no decode kernel launched. Then the float32 twins (qwen3-moe
   on both paths, qwen3-8b, gemma2-2b, hymba-1.5b, xlstm-125m, seamless)
   card against CPU: the grads of a batch and 3 train steps' losses and
   params within 1e-4; a resume at smoke size on the card (4 steps
   straight against 2, a checkpoint, a restore and 2 more: the same bits);
   and ``python -m repro_torch.launch.train`` (a checkpoint, then
   ``--resume``), ``python -m repro_torch.examples.quickstart`` and
   ``python -m repro_torch.examples.fault_tolerance_demo`` (its bit-exact
   resume assert) as subprocesses on the card. The kernel phase holds the
   expert GEMMs at the training shapes (the ragged forward and its two dx
   products with dy rounded to bf16; the padded forward, dx and dw at C =
   160) and times the ragged dw;
13. the ``sharded`` phase (ROADMAP Queue A item 11a), the earlier
   phases' weights freed first: qwen3-moe-30b-a3b at full width and
   ``--layers`` layers under ``make_policy(..., "serve")`` on a (1, 1)
   NCCL mesh, for a decode cell of 8 rows over 32768-slot rings: a prefill
   of 8 x 1024 tokens and 16 decode steps give the same bits with the
   policy and without it; split-K forced to 4 and to 8 (on 2048-slot rings
   the context spans) launches ``flash_decode`` that many times a
   layer-step on the tensor cores, its logits within the bf16 bar of each
   row's norm on the rows routed as the unsplit step's, each layer's
   attention held row by row, one layer's device time split and unsplit;
   then the script starts itself twice, as two ranks of a (1, 2) mesh over
   gloo on the one card: each holds exactly its spec's share of the
   weights (half the experts, heads' columns, vocabulary and ring), each
   layer's attention and MoE fed the one-rank run's inputs meet its
   outputs at the bf16 bar with exact statistics, a decode step's wall and
   its collectives' share are printed, and the float32 twin of the smoke
   config on the two ranks meets the CPU within 1e-5. The kernel phase
   holds ``flash_decode``'s split-K shards (1 of 4 and 1 of 8 of a
   32768-slot ring, f32 output and log-sum-exp) beside SDPA on the shard;
14. prints a ``kernels`` JSON line (all seven kernels; the train and
   sharded phases' launches under ``launches_by_path``), then as its last
   line ``{"ok": true, "device": {...}}``.

Adopting a placement moves the experts' weights in place; each serve
leaves the caller's weights as they were.

The kernel launch counters are set to 0 just before each serve of steps 4,
6, 7, 9, 10 and 11, of each entry-point run of steps 10 and 11, of each
scenario slice of step 8, of each full-width training run of step 12 and
of the policy's run and each split decode step of step 13, and read just
after;
each serve fails if a kernel of its path was not launched, or if a bf16
launch of an expert GEMM or of a decode kernel at full width took the CUDA
cores instead of the tensor cores (at hd 256, which
``decode_route.tc_eligible`` leaves to the CUDA cores, the reverse).

Any failure raises, and the script exits non-zero. It never runs on the
CPU: without a CUDA device it exits with an error before doing anything.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
    # one rank of the sharded phase's two-rank world (the script starts
    # them itself)
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-job", default=None, help=argparse.SUPPRESS)
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
        and then drops an event, the events of one call, or every event of
        a profile: a profile is taken (up to six times) until each kernel
        shows its launches per call in all the calls but one (launches per
        call: its count over the calls, rounded; a kernel a library call
        launched twice a call once showed 18 events in 10 calls), and, for
        a library call, until two profiles agree on its kernels, so that one
        the profiler missed entirely shows. For a library call only the
        kernels steady in a profile (their launches per call in all calls
        but one) count: a stray event seen once, in one profile, is no
        kernel of the call and must not keep later profiles from agreeing
        (a bincount's profiles once never agreed for that). A
        kernel's time per call is its mean over its events times its
        launches per call. Returns (ms, {kernel: ms})."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        seen, complete = set(), 0
        for _ in range(6):
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
                n >= per_call[k] * (self.iters - 1)
                for k, n in counts.items())
            if match:
                if whole and len(parts) == n_kernels:
                    break
                continue
            steady = {k for k, n in counts.items()
                      if n >= per_call[k] * (self.iters - 1)}
            parts = {k: parts[k] for k in steady}
            counts = {k: counts[k] for k in steady}
            if not steady <= seen:        # a kernel no earlier profile saw
                seen |= steady
                complete = 0
            complete += bool(steady) and steady == seen
            if complete == 2:
                break
        else:
            raise AssertionError(f"profiler did not see the kernels of "
                                 f"{match or 'the call'} in {self.iters} "
                                 f"calls (less one event) in six tries: "
                                 f"{counts}, kernels seen {sorted(seen)}")
        per_call = {k: parts[k] / counts[k] * per_call[k] for k in parts}
        return sum(per_call.values()), per_call


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def lse_err(a, b) -> float:
    """max |a - b| over log-sum-exps, 0 where both are -inf (a split-K
    shard with no valid slot), inf where only one is."""
    both = torch.isneginf(a) & torch.isneginf(b)
    d = (a.float() - b.float()).abs().masked_fill(both, 0.0)
    return float(d.max()) if d.numel() else 0.0


def bar_err(a, b) -> float:
    """max |a - b| / (1 + |b|): within a bar t iff ``allclose(a, b,
    rtol=t, atol=t)`` holds (about), as the tests hold bf16 outputs."""
    if not a.numel():
        return 0.0
    b = b.float()
    return float(((a.float() - b).abs() / (1 + b.abs())).max())


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


def check_paged_decode(timer, dtype, int8_pages=False, long_ctx=False,
                       Hq=32, Hkv=4):
    """The serving shape (8 requests up to 1024 tokens, lane 0 empty), or a
    32768-token context over a pool of 16385 pages (0.54 GB in bf16).
    Heads: qwen3-moe's 32/4 (G = 8), llama4's 40/8 (G = 5), qwen3-8b's
    32/8 (G = 4) or qwen1.5-32b's 40/40 (G = 1)."""
    from repro_torch.kernels.decode_route import row_rel_err, tc_eligible
    from repro_torch.kernels.kv_pack import pack_kv_plain
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, hd, ps = 8, 128, 16
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
            "library_ms": None, "route": route,
            "tc_expected": tc_eligible(dtype, hd, Hq // Hkv)}


def dispatch_layout(T, K, E, D, dtype, g):
    from repro_torch.kernels.moe_dispatch import pick_row_block, ragged_dispatch
    logits = torch.randn(T, E, generator=g, device="cuda")
    ids = torch.topk(logits, K, dim=-1).indices.to(torch.int32)
    x = torch.randn(T, D, generator=g, device="cuda").to(dtype)
    nb = pick_row_block(T * K, E)
    return ragged_dispatch(x, ids, E, row_block=nb)


def check_gmm(timer, dtype, T, D, F, which, K=8, dx=False):
    """qwen3's top-8 of 128 experts (2048 <-> 768), or llama4's top-1 of
    128 (5120 <-> 8192: a 10 GiB bf16 weight stack). The weights are drawn
    one expert at a time, so the draw's f32 buffer is one expert's.
    ``dx``: the product that ``kernels/moe_dispatch.ragged_gmm``'s backward
    issues for a forward with these weights, the incoming dy (Np, F) in f32
    rounded to ``dtype`` against a contiguous wᵀ (E, F, D), held to the
    plain f32 formulation (dy not rounded); the timed call is the
    kernel's, after the rounding."""
    from repro_torch.kernels.moe_gmm import (moe_gmm_ragged,
                                             moe_gmm_ragged_plain)
    g = torch.Generator(device="cuda").manual_seed(2)
    E = 128
    disp = dispatch_layout(T, K, E, D, dtype, g)
    w = torch.empty(E, D, F, dtype=dtype, device="cuda")
    for e in range(E):
        w[e] = torch.randn(D, F, generator=g, device="cuda") / np.sqrt(D)
    x = x_plain = disp.xs
    if dx:
        w = w.transpose(1, 2).contiguous()
        x_plain = torch.randn(disp.xs.shape[0], F, generator=g,
                              device="cuda")
        x = x_plain.to(dtype)
    Din, Dout = w.shape[1:]
    meta = (disp.tile_expert, disp.group_sizes, disp.padded_offsets)
    nb = disp.row_block
    tc_before = moe_gmm_ragged.tc_launches
    out = moe_gmm_ragged(x, w, *meta, n_block=nb)
    route = route_name(moe_gmm_ragged.tc_launches - tc_before)
    ref = moe_gmm_ragged_plain(x_plain, w, *meta, n_block=nb)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    item = x.element_size()
    rows = int(disp.group_sizes.sum())
    hit = int((disp.group_sizes > 0).sum())
    Np = x.shape[0]
    nbytes = rows * Din * item + hit * Din * Dout * item + Np * Dout * 4 \
        + 4 * (disp.tile_expert.numel() + 2 * E + 1)
    ops = 2.0 * rows * Din * Dout
    lib = {"library_ms": None}
    if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        offs = disp.padded_offsets[1:].contiguous()
        # bf16 out: the library rounds its output to the input type
        lib = library_times(timer, lambda: torch._grouped_mm(x, w,
                                                             offs=offs))
    run = lambda: moe_gmm_ragged(x, w, *meta, n_block=nb)  # noqa: E731
    return {"shape": f"{which}: T={T} K={K} E={E} D={Din} F={Dout} "
                     f"nb={nb} Np={Np} rows={rows} experts_hit={hit}",
            "err": err, "ms": timer(run),
            **device_times(timer, run, ("gmm_",), 1),
            "plain_ms": timer(lambda: moe_gmm_ragged_plain(
                x_plain, w, *meta, n_block=nb)),
            "bound": bound_ms(nbytes, ops, str(dtype).split(".")[1]),
            **lib, "route": route}


def check_flash_decode(timer, dtype, long_ctx=False, Hq=32, Hkv=4, hd=128,
                       L=1024, window=0, cap=0.0, int8=False, which=""):
    """The dense ring cache of a RealModelEngine at full width: 8 rows of L
    slots at assorted write positions (one wrapped past the end of the
    ring, one fully masked: exact zeros); or, ``long_ctx``, 8 rings of
    32768 slots, most of them full. Heads qwen3-moe's 32/4 by default;
    ``window`` and ``cap`` add the sliding window and the logit softcap,
    ``int8`` an int8 cache with f32 scales. The library yardstick, SDPA
    with a boolean mask, only where it computes the same function: no
    softcap, no int8."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_route import row_rel_err, tc_eligible
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.kv_pack import pack_kv_plain
    from repro_torch.models.attention import ring_positions
    g = torch.Generator(device="cuda").manual_seed(6)
    B = 8
    if long_ctx:
        L = 32768
        write = [32767, 40000, 65535, 32767, 50000, 32767, 20000, 32767]
    else:
        write = [w * L // 1024
                 for w in (99, 1500, 255, 600, 931, 1023, 0, 400)]
    q = torch.randn(B, Hq, hd, generator=g, device="cuda").to(dtype)
    scales = {}
    if int8:      # drawn a head at a time: the f32 draw is 1/Hkv of it
        kc, vc = (torch.empty(B, L, Hkv, hd, dtype=torch.int8, device="cuda")
                  for _ in range(2))
        ks, vs = (torch.empty(B, L, Hkv, device="cuda") for _ in range(2))
        for h in range(Hkv):
            for c, sc in ((kc, ks), (vc, vs)):
                c[:, :, h], sc[:, :, h] = pack_kv_plain(torch.randn(
                    B, L, hd, generator=g, device="cuda"))
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dtype)
        vc = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dtype)
    write = torch.tensor(write, device="cuda")
    k_pos = ring_positions(write, L)
    q_pos = write.to(torch.int32)
    if not long_ctx:
        k_pos[6] = -1                                  # row 6: no valid slot
    terms = dict(window=window, softcap=cap, **scales)
    tc_before = flash_decode.tc_launches
    out = flash_decode(q, kc, vc, k_pos, q_pos, **terms)
    route = route_name(flash_decode.tc_launches - tc_before)
    ref = flash_decode_plain(q, kc, vc, k_pos, q_pos, **terms)
    torch.cuda.synchronize()
    err, rel = max_err(out, ref), row_rel_err(out, ref)
    if not torch.isfinite(out).all() or \
            (not long_ctx and out[6].abs().max() != 0):
        raise AssertionError("flash_decode: non-finite output or a row with "
                             "no valid slot that is not exactly zero")
    del ref
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        valid &= k_pos > q_pos[:, None] - window
    n_valid = int(valid.sum())
    item = q.element_size()
    # K and V of the valid slots (codes and scales on an int8 cache)
    row_bytes = hd * kc.element_size() + (4 if int8 else 0)
    nbytes = 2 * q.numel() * item + n_valid * Hkv * 2 * row_bytes \
        + k_pos.numel() * 4 + B * 4
    ops = 4.0 * n_valid * Hq * hd
    lib = lib_dev = None
    if not (cap or int8):
        # SDPA on the same cache, heads-first copies and the boolean mask
        # built outside the timed call
        q4 = q[:, :, None].contiguous()                # (B, Hq, 1, hd)
        k4, v4 = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        mask = valid[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, attn_mask=mask, enable_gqa=True)
        try:
            sdpa()
        except (TypeError, RuntimeError) as exc:
            log(f"library: scaled_dot_product_attention with enable_gqa "
                f"not timed ({exc})")
        else:
            # event time as for every library call, and device time, to
            # set against the kernel's own device time without either's
            # host work
            lib = timer(sdpa)
            lib_dev = dict(zip(("library_device_ms", "library_device_parts"),
                               timer.device(sdpa)))
    what = (f"long context: L={L} ring, write positions {write.tolist()}"
            if long_ctx else f"L={L} ring, write positions "
            f"{write.tolist()}, row 6 masked")
    extra = ", ".join(x for x in (
        f"window {window}" if window else "", f"softcap {cap:g}" if cap
        else "", "int8 cache + f32 scales" if int8 else "") if x)
    run = lambda: flash_decode(q, kc, vc, k_pos, q_pos, **terms)  # noqa
    return {"shape": f"{which}B={B} Hq={Hq} Hkv={Hkv} hd={hd} {what}, "
                     f"{n_valid} valid slots" + (f", {extra}" if extra
                                                 else ""),
            "err": err, "row_rel_err": rel,
            "ms": timer(run), **device_times(timer, run),
            "plain_ms": timer(lambda: flash_decode_plain(q, kc, vc, k_pos,
                                                         q_pos, **terms)),
            "bound": bound_ms(nbytes, ops, str(dtype).split(".")[1]),
            "library_ms": lib, **(lib_dev or {}), "route": route,
            "tc_expected": tc_eligible(dtype, hd, Hq // Hkv)}


def check_pack_ring(timer, dtype, B, S, L, Hkv, which):
    """The int8 write of a dense ring cache (``pack_kv_into_ring``: one
    launch for K and V of a layer) at qwen1.5-32b's width (40 KV heads of
    128), bit for bit against the plain twin on the whole cache: a decode
    step of 8 rows at assorted positions (two past the ring's end), or a
    prompt of S tokens written at slots [0, S)."""
    from repro_torch.kernels.kv_pack import (pack_kv_into_pages_plain,
                                             pack_kv_into_ring)
    g = torch.Generator(device="cuda").manual_seed(10)
    hd = 128
    if S == 1:
        positions = torch.tensor([0, 1, 255, 1023, L - 1, L, 3 * L + 5, 700],
                                 device="cuda")[:B, None]
    else:
        positions = torch.arange(S, device="cuda")[None].repeat(B, 1)
    positions = positions.to(torch.int32)
    k, v = ((torch.randn(B, S, Hkv, hd, generator=g, device="cuda")
             * torch.rand(B, S, Hkv, 1, generator=g, device="cuda") * 8)
            .to(dtype) for _ in range(2))
    caches = [torch.randint(-127, 128, (B, L, Hkv, hd), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2)] + \
        [torch.rand(B, L, Hkv, generator=g, device="cuda") for _ in range(2)]
    plain = [t.clone() for t in caches]
    bt = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    valid = torch.ones(B, S, dtype=torch.bool, device="cuda")
    pack_kv_into_ring(k, v, *caches, positions)
    pack_kv_into_pages_plain(k, v, *plain, bt, positions, valid)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(caches, plain)):
        raise AssertionError(f"pack_kv_into_ring [{dtype}] {which}: codes "
                             "or scales differ from the plain twin")
    n = B * S * Hkv
    nbytes = 2 * n * (hd * k.element_size() + hd + 4) + 4 * positions.numel()
    run = lambda: pack_kv_into_ring(k, v, *caches, positions)  # noqa: E731
    return {"shape": f"{which}: K and V ({B}, {S}, {Hkv}, {hd}) into an "
                     f"int8 ring cache of {L} slots (one launch)",
            "err": 0.0, "ms": timer(run),
            **device_times(timer, run, ("pack_kv_kernel",), 1),
            "plain_ms": timer(lambda: pack_kv_into_pages_plain(
                k, v, *plain, bt, positions, valid)),
            "bound": bound_ms(nbytes, 2 * 4.0 * n * hd, "float32"),
            "library_ms": None}


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


def check_pack_paged(timer, dtype, B, S, which, Hkv=4):
    """The whole int8 KV write of one layer in one launch: K and V of a
    (B, S) chunk at full width (KV heads of 128) into a pool of int8
    pages of 16 tokens, against the plain twin (``pack_kv_plain`` and the
    four index-puts), bit for bit on every page but page 0, where invalid
    rows race. Decode: 8 lanes at assorted contexts, lane 3 idle; prefill:
    one 512-token chunk starting mid-page, its last 12 rows padding. KV
    heads: qwen3's 4, or llama4's 8."""
    from repro_torch.kernels.kv_pack import (pack_kv_into_pages,
                                             pack_kv_into_pages_plain)
    g = torch.Generator(device="cuda").manual_seed(8)
    hd, ps, NB = 128, 16, 64
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
        # bf16 takes the tensor cores wherever tc_eligible admits the
        # shape (hd 256 does not), and nothing else does
        if kname.endswith("_decode") and \
                (r["route"] == "tensor cores") != r["tc_expected"]:
            raise AssertionError(f"{kname} [{dt}] {r['shape']}: took the "
                                 f"{r['route']} (tensor cores expected: "
                                 f"{r['tc_expected']})")
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
    # the grid above SINGLE_BLOCK_SLOTS, and the sorted-ids shape of before;
    # then llama4's top-1 decode step and 512-token chunk
    for T, K in ((8, 8), (256, 8), (2048, 8), (2048, 1), (8, 1), (512, 1)):
        record("source_expert_count", "int32",
               check_stats(timer, T, K))
    llama4_kernel_rows(timer, record)
    dense_families_kernel_rows(timer, record)
    other_families_kernel_rows(timer, record)
    train_kernel_rows(timer, record)
    sharded_kernel_rows(timer, record)
    return results


def time_ragged_dw(timer, T=2048, K=8, D=2048, F=768):
    """The ragged path's weight gradient (PyTorch ops in the reference's
    formulation, no kernel of this repository) at the training shapes:
    its time a call, and two calls' bits, logged."""
    from repro_torch.kernels.moe_dispatch import ragged_dw
    g = torch.Generator(device="cuda").manual_seed(6)
    E = 128
    disp = dispatch_layout(T, K, E, D, torch.bfloat16, g)
    dy = torch.randn(disp.xs.shape[0], F, generator=g, device="cuda")
    run = lambda: ragged_dw(disp.xs, dy, disp.tile_expert,  # noqa: E731
                            disp.padded_offsets, E,
                            row_block=disp.row_block)
    same = torch.equal(run(), run())
    if not same:
        raise AssertionError("ragged_dw: two calls on the same inputs "
                             "differ")
    log(f"train: ragged dw (PyTorch ops: per-tile f32 bmm in slabs of 64 "
        f"tiles, runs summed in order) at T={T} K={K} E={E} D={D} F={F}: "
        f"{timer(run):.4f} ms a call (CUDA events), two calls the same "
        f"bits")


def train_kernel_rows(timer, record):
    """The expert GEMMs at the train phase's shapes (4 x 512 tokens, top-8
    of 128 experts, 2048 <-> 768, bf16): the ragged GMM's forward gate/up
    and its two dx products; the padded GMM's forward, dx (dy @ wᵀ) and dw
    (xᵀ @ dy) of gate/up at C = 160 (4 rows of 40 slots); the ragged dw's
    time. The statistics kernel's row at T·K = 16384 (its grid path) is
    the kernel phase's (2048, 8) row."""
    dt = "bfloat16"
    record("moe_gmm_ragged", dt, check_gmm(timer, torch.bfloat16, 2048,
                                           2048, 768, "train forward "
                                           "gate/up"))
    for D, F, proj in ((2048, 768, "gate/up"), (768, 2048, "down")):
        record("moe_gmm_ragged", dt + "/dx",
               check_gmm(timer, torch.bfloat16, 2048, D, F,
                         f"train dx {proj} (dy rounded to bf16)", dx=True))
    for E, C, D, F, which in (
            (128, 160, 2048, 768, "train forward gate/up"),
            (128, 160, 768, 2048, "train dx gate/up (dy @ wT)"),
            (128, 2048, 160, 768, "train dw gate/up (xT @ dy)")):
        record("moe_gmm", dt,
               check_padded_gmm(timer, torch.bfloat16, E, C, D, F, which))
    time_ragged_dw(timer)
    torch.cuda.empty_cache()


def llama4_kernel_rows(timer, record):
    """The five kernels of the paged path at llama4-maverick's serving
    shapes: decode with 40 query heads over 8 KV heads (G = 5) on fp and
    int8 pages (bf16 on the tensor cores, f32 on the CUDA cores), its int8
    KV write and dequantization with 8 KV heads, and the ragged GEMMs of a
    top-1 decode step and a 512-token prefill chunk over 128 experts of
    5120 <-> 8192 (bf16)."""
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        for int8 in (False, True):
            r = check_paged_decode(timer, dtype, int8_pages=int8, Hq=40,
                                   Hkv=8)
            r["shape"] = "llama4: " + r["shape"]
            record("paged_decode", dt + ("/int8" if int8 else ""), r)
    dt = "bfloat16"
    for B, S, which in ((8, 1, "llama4 decode"),
                        (1, 512, "llama4 prefill chunk")):
        record("pack_kv", dt + "/paged",
               check_pack_paged(timer, torch.bfloat16, B, S, which, Hkv=8))
    r = check_unpack(timer, torch.bfloat16, (8, 1024, 8, 128))
    r["shape"] = "llama4 " + r["shape"]
    record("unpack_kv", dt, r)
    for T, which in ((8, "llama4 decode"), (512, "llama4 prefill")):
        for D, F, proj in ((5120, 8192, "gate/up"), (8192, 5120, "down")):
            record("moe_gmm_ragged", dt,
                   check_gmm(timer, torch.bfloat16, T, D, F,
                             f"{which} {proj}", K=1))
            torch.cuda.empty_cache()


def dense_families_kernel_rows(timer, record):
    """The decode kernels and the dense int8 write at the dense families'
    shapes: ``paged_decode`` at qwen3-8b's 32/8 heads (G = 4) and
    qwen1.5-32b's 40/40 (G = 1), on fp and int8 pages; ``flash_decode``
    with gemma2's window and softcap at hd 256 over a cache longer than the
    window (a serve's ring of L = window slots never masks), at gemma3's
    hd 256 and G = 2, and on int8 caches at G = 4 and G = 1 (also at a
    32768-slot context in bf16); the int8 write of a dense ring cache at
    qwen1.5's 40 KV heads."""
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        heads = ((32, 8, "qwen3-8b"), (40, 40, "qwen1.5-32b"))
        for Hq, Hkv, name in heads:
            for int8 in (False, True):
                r = check_paged_decode(timer, dtype, int8_pages=int8, Hq=Hq,
                                       Hkv=Hkv)
                r["shape"] = f"{name}: " + r["shape"]
                record("paged_decode", dt + ("/int8" if int8 else ""), r)
        record("flash_decode", dt + "/window+softcap", check_flash_decode(
            timer, dtype, Hq=8, Hkv=4, hd=256, L=8192, window=4096,
            cap=50.0, which="gemma2 heads: "))
        record("flash_decode", dt, check_flash_decode(
            timer, dtype, Hq=16, Hkv=8, hd=256, L=2048,
            which="gemma3 heads: "))
        for Hq, Hkv, name in heads:
            record("flash_decode", dt + "/int8", check_flash_decode(
                timer, dtype, Hq=Hq, Hkv=Hkv, int8=True, which=f"{name}: "))
            if dtype == torch.bfloat16:
                record("flash_decode", dt + "/int8", check_flash_decode(
                    timer, dtype, long_ctx=True, Hq=Hq, Hkv=Hkv, int8=True,
                    which=f"{name}: "))
                torch.cuda.empty_cache()
        for B, S, which in ((8, 1, "qwen1.5-32b decode"),
                            (1, 1024, "qwen1.5-32b prompt")):
            record("pack_kv", dt + "/ring",
                   check_pack_ring(timer, dtype, B, S, 2048, 40, which))


def other_families_kernel_rows(timer, record):
    """``flash_decode`` at hymba-1.5b's 25/5 heads of 64 (G = 5) over 4096
    slots with its window of 1024 (a cache longer than the window, so the
    window masks) and over 2048 slots without (its global layers), and at
    llava-next-34b's 56/8 heads of 128 (G = 7) over 4096 slots, on bf16 and
    int8 caches; the dense int8 write at llava's 8 KV heads."""
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        record("flash_decode", dt + "/window", check_flash_decode(
            timer, dtype, Hq=25, Hkv=5, hd=64, L=4096, window=1024,
            which="hymba local: "))
        record("flash_decode", dt, check_flash_decode(
            timer, dtype, Hq=25, Hkv=5, hd=64, L=2048,
            which="hymba global: "))
        for int8 in (False, True):
            record("flash_decode", dt + ("/int8" if int8 else ""),
                   check_flash_decode(timer, dtype, Hq=56, Hkv=8, hd=128,
                                      L=4096, int8=int8, which="llava: "))
        for B, S, which in ((8, 1, "llava-next-34b decode"),
                            (1, 2880, "llava-next-34b prompt")):
            record("pack_kv", dt + "/ring",
                   check_pack_ring(timer, dtype, B, S, 4096, 8, which))


# the rings' newest positions of the shard rows: the long-context row's 8
# rings of 32768 slots (most full), and the sharded phase's decode on
# 2048-slot rings after a prefill of 1024 tokens
SHARD_WRITES = {32768: [32767, 40000, 65535, 32767, 50000, 32767, 20000,
                        32767],
                2048: [1039, 1024, 1031, 1039, 1027, 1035, 1039, 1030]}


def check_flash_decode_shard(timer, dtype, L, n_split):
    """One split-K shard of ``flash_decode`` at qwen3-moe's 32/4 heads: 8
    rings of ``L`` slots (newest positions ``SHARD_WRITES[L]``) cut into
    ``n_split`` shards; shard 0, a slice of the cache read in place, returns
    its f32 output and log-sum-exp (``return_lse``), held to its plain twin
    on the same slots (outputs and each row's own norm; the log-sum-exps
    within the same bar). The bound counts the shard's valid K and V, q,
    the positions and the f32 outputs; the library yardstick is SDPA on the
    shard with a boolean mask (it returns no log-sum-exp)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_route import row_rel_err, tc_eligible
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.models.attention import ring_positions
    g = torch.Generator(device="cuda").manual_seed(6)
    B, Hq, Hkv, hd = 8, 32, 4, 128
    write = torch.tensor(SHARD_WRITES[L], device="cuda")
    q = torch.randn(B, Hq, hd, generator=g, device="cuda").to(dtype)
    kc = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dtype)
    vc = torch.randn(B, L, Hkv, hd, generator=g, device="cuda").to(dtype)
    Ls = L // n_split
    k_pos = ring_positions(write, L)[:, :Ls].contiguous()
    q_pos = write.to(torch.int32)
    ks, vs = kc[:, :Ls], vc[:, :Ls]
    tc_before = flash_decode.tc_launches
    out, lse = flash_decode(q, ks, vs, k_pos, q_pos, return_lse=True)
    route = route_name(flash_decode.tc_launches - tc_before)
    ref, ref_lse = flash_decode_plain(q, ks.contiguous(), vs.contiguous(),
                                      k_pos, q_pos, return_lse=True)
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or not torch.isfinite(out).all() \
            or not torch.isfinite(lse).all():
        raise AssertionError("flash_decode shard: the output must be f32 "
                             "and finite, with finite log-sum-exps")
    err = max(max_err(out, ref), lse_err(lse, ref_lse))
    rel = row_rel_err(out, ref)
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    n_valid = int(valid.sum())
    item = q.element_size()
    nbytes = q.numel() * item + n_valid * Hkv * 2 * hd * item \
        + k_pos.numel() * 4 + B * 4 + out.numel() * 4 + lse.numel() * 4
    ops = 4.0 * n_valid * Hq * hd
    q4 = q[:, :, None].contiguous()
    k4, v4 = (t.transpose(1, 2).contiguous() for t in (ks, vs))
    mask = valid[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    run = lambda: flash_decode(q, ks, vs, k_pos, q_pos,  # noqa: E731
                               return_lse=True)
    return {"shape": f"split-K shard 1 of {n_split}: B={B} Hq={Hq} "
                     f"Hkv={Hkv} hd={hd}, slots [0, {Ls}) of {L}-slot "
                     f"rings read in place, {n_valid} valid slots, f32 "
                     f"output + log-sum-exp",
            "err": err, "row_rel_err": rel,
            "ms": timer(run), **device_times(timer, run),
            "plain_ms": timer(lambda: flash_decode_plain(
                q, ks, vs, k_pos, q_pos, return_lse=True)),
            "bound": bound_ms(nbytes, ops, str(dtype).split(".")[1]),
            "library_ms": timer(sdpa),
            **dict(zip(("library_device_ms", "library_device_parts"),
                       timer.device(sdpa))),
            "route": route, "tc_expected": tc_eligible(dtype, hd, Hq // Hkv)}


def sharded_kernel_rows(timer, record):
    """``flash_decode``'s split-K shards, bf16 on the tensor cores and f32
    on the CUDA cores: shard 1 of 2 of a 32768-slot ring (the sharded
    phase's two ranks, kv_split 2 over ``model``), of 4 and of 8 (a decode
    cell's kv_split at 32k), and 1 of 4 and of 8 of a 2048-slot ring (the
    phase's split-K on one card)."""
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        for L, n in ((32768, 2), (32768, 4), (32768, 8), (2048, 4),
                     (2048, 8)):
            record("flash_decode", dt + f"/split-K {n} of {L}",
                   check_flash_decode_shard(timer, dtype, L, n))
        torch.cuda.empty_cache()


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


def check_routes(phase, launches, tc, mains, cuda_cores=()):
    """At full width in bf16 every launch of an expert GEMM or a decode
    kernel takes the tensor cores: each kernel of ``mains`` (the path's GEMM
    and decode kernel) launched there, none on the CUDA cores. The kernels
    of ``cuda_cores`` (the decode kernel at hd 256, which
    ``decode_route.tc_eligible`` leaves to the CUDA cores) launched, and
    never on the tensor cores."""
    for name in cuda_cores:
        if launches[name] <= 0 or tc[name]:
            raise AssertionError(f"{phase}: {name} launched {launches[name]} "
                                 f"times, {tc[name]} on the tensor cores; "
                                 "expected the CUDA cores only")
    for name, n_tc in tc.items():
        if name not in cuda_cores and launches[name] - n_tc:
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
    llama4_reference()


def weight_fingerprint(params):
    """Per expert row of every stacked expert leaf (and per leaf of the
    rest), the sum of its bits read as int16: equal before and after a
    serve only if every row holds the same bits in the same slot, as far
    as a sum can tell. Leaf by leaf and row by row, so that no copy of the
    weights is made."""
    from repro_torch.bridge import tree_leaves
    out = []
    for t in tree_leaves(params):
        bits = t.view(torch.int16) if t.element_size() == 2 else \
            t.view(torch.int32)
        rows = bits.reshape(-1, *bits.shape[-2:]) if t.dim() >= 3 else \
            bits[None]
        out.append(torch.stack([r.sum(dtype=torch.int64) for r in rows])
                   .cpu())
    return out


def llama4_reference():
    """llama4-maverick's float32 twin (smoke widths, one period: a dense
    layer, then a MoE layer with a shared expert) through serve_real_cluster
    on two paged engines, with uncalibrated placement and with predictive
    placement and staged prefetch: the card and the CPU give the same
    tokens, decisions, migrations, expert moves and staged adoptions, and
    each serve leaves the caller's weights as they were."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.core import PlacementConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import PagedEngineConfig
    cfg = reduced(get_smoke_config("llama4-maverick-400b-a17b"), n_layers=2,
                  dtype="float32")
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    params_gpu = tree_map(lambda t: t.to("cuda"), params)
    keys = ("decisions", "migrations", "expert_moves",
            "prefetch_pointer_swaps", "per_engine", "unfinished")
    for predictive in (False, True):
        out = {}
        for dev, p in (("cpu", params), ("cuda", params_gpu)):
            ecfg = PagedEngineConfig(page_size=8, n_pages=48,
                                     max_blocks_per_req=8, max_batch=4,
                                     token_budget=16, chunk_buckets=(8, 16),
                                     device=dev)
            reqs = make_requests(cfg, 8, 6, 30, 5, seed=5, gap=0.1)
            before = weight_fingerprint(p)
            res, _, _ = serve_cluster(
                cfg, p, ecfg, reqs, window_tokens=48,
                placement_cfg=PlacementConfig.uncalibrated(),
                predictive=predictive, prefetch=predictive)
            if not all(torch.equal(a, b) for a, b in
                       zip(before, weight_fingerprint(p))):
                raise AssertionError(f"llama4 float32 twin ({dev}): the "
                                     "serve changed the caller's weights")
            out[dev] = ([r.full_output_tokens for r in reqs],
                        {k: res.signals[k] for k in keys})
        what = ("predictive placement, staged prefetch" if predictive
                else "uncalibrated placement")
        (toks_c, sig_c), (toks_g, sig_g) = out["cpu"], out["cuda"]
        if toks_c != toks_g or sig_c != sig_g:
            diff = [k for k in keys if sig_c[k] != sig_g[k]]
            raise AssertionError(f"llama4 float32 twin cluster ({what}): card "
                                 f"and CPU disagree (tokens equal: "
                                 f"{toks_c == toks_g}; signals that differ: "
                                 f"{diff})")
        if sig_g["migrations"] <= 0 or sig_g["unfinished"] or \
                (predictive and sig_g["prefetch_pointer_swaps"] <= 0):
            raise AssertionError(f"llama4 float32 twin cluster ({what}): "
                                 f"expected migrations (and staged "
                                 f"adoptions) and a finished run, got {sig_g}")
        log(f"reference: llama4 float32 twin cluster, {what}: card kernels "
            f"and CPU plain versions give the same {sum(map(len, toks_c))} "
            f"tokens, decisions {sig_g['decisions']}, "
            f"{sig_g['migrations']} migrations ({sig_g['expert_moves']} "
            f"expert moves, {sig_g['prefetch_pointer_swaps']} staged "
            f"adoptions); the caller's weights unchanged after each serve")


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
    # experts' weights in place through this function, once per distinct
    # weight tree
    moves = []
    migrate = timed_migrations(tfm, cfg, moves, [0])
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
        f"({sig['expert_moves']} expert moves), wall ms and peak rise MiB "
        f"of each move {each_move(moves)}, kv_peak {sig['kv_peak']:.4f}")
    log(f"cluster: int8 pool holds {fp / i8:.4f}x the tokens per byte of "
        f"the bf16 pool ({i8} against {fp} bytes per page across "
        f"{cfg.n_layers} layers); launches {launches}, on the tensor cores "
        f"{tc}")
    del res, engines

    forwards = [0]

    def again():
        forwards[0] = 0
        res, _, _ = serve_cluster(
            cfg, params, ecfg, make_requests(cfg, 16, 100, 900, new_tokens,
                                             seed=args.seed + 1, gap=0.1),
            window_tokens=1024, placement_cfg=PlacementConfig.uncalibrated())
        return f"{res.signals['rounds']} rounds, {forwards[0]} forward passes"

    restore = counted_forwards(tfm, forwards)
    try:
        profile_until_complete("cluster", again, lambda rows: (
            profile_write_and_stats(rows, forwards[0] * cfg.n_layers,
                                    forwards[0] * cfg.n_moe_layers)))
    finally:
        restore()
    return launches, tc


def profile_until_complete(label, serve, check, tries=3):
    """``serve()`` under :func:`profiled` until ``check(rows)`` passes on
    one profile, at most ``tries`` profiles. The profiler now and then loses
    a block of events (on an H100, one profile of the int8 cluster serve
    showed 1056 of its 1096 write kernels, which the launch counters showed
    all 1096 times),
    so a count check that fails is taken again on a new profile of a new
    serve, and the last failure is raised. Returns the passing profile's
    rows."""
    for i in range(tries):
        rows, _ = profiled(label, serve)
        try:
            check(rows)
            return rows
        except AssertionError as exc:
            if i == tries - 1:
                raise
            log(f"profile {label}: {exc}; profiling a new serve")


def profile_write_and_stats(rows, layer_steps, moe_steps, label="cluster"):
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
        raise AssertionError(f"profile {label}: expected one int8 write "
                             f"kernel per layer-step ({layer_steps}) and one "
                             f"single-block stats kernel per MoE layer-step "
                             f"({moe_steps}), saw {writes} writes, {blocks} "
                             f"single-block and {grids} grid stats kernels")
    n_kernels = sum(n for _, n, key in rows if "emset" not in key)
    memsets = sum(n for _, n, key in rows if "emset" in key)
    log(f"profile {label}: {layer_steps} layer-steps: {writes} int8 KV write "
        f"kernels (one per layer-step), {blocks} stats kernels on one block "
        f"(one per MoE layer-step, no memset); {n_kernels} device kernels "
        f"and {memsets} memsets in all, {n_kernels / layer_steps:.1f} kernels "
        f"per layer-step")


def timed_migrations(tfm, cfg, adoptions, peak):
    """Wrap tfm.migrate_params_for_placement (each live adoption of a
    placement) to record, for each call, its wall s, the expert rows it
    moved, their bytes and the rise of the card's peak memory across it
    over what was allocated just before. Each call resets the peak
    counter, so ``peak[0]`` keeps the largest peak seen before a reset.
    Returns the original to restore."""
    migrate = tfm.migrate_params_for_placement
    ewb = tfm.expert_weight_bytes(cfg)

    def timed(params, mcfg, old, new):
        moved = int((np.asarray(old) != np.asarray(new)).sum())
        torch.cuda.synchronize()
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = migrate(params, mcfg, old, new)
        torch.cuda.synchronize()
        adoptions.append({"s": time.perf_counter() - t0, "rows": moved,
                          "bytes": moved * ewb,
                          "rise": torch.cuda.max_memory_allocated() - base})
        return out

    tfm.migrate_params_for_placement = timed
    return migrate


def each_move(moves):
    """(wall ms, peak rise MiB) of each timed move."""
    return [(round(m["s"] * 1e3, 1), round(m["rise"] / 2**20)) for m in moves]


def dense_cluster_phase(args, cfg, params, counters):
    """16 requests arriving over time through serve_real_cluster on two
    dense-cache RealModelEngines with the capacity-padded MoE dispatch,
    under the Gimbal scheduler and an uncalibrated placement whose small
    window makes experts migrate (the engines share one weight tree,
    moved once per adoption)."""
    from repro_torch.core import PlacementConfig
    from repro_torch.models import transformer as tfm
    max_slots, max_len, new_tokens = 8, 1024, 32
    reqs = make_requests(cfg, 16, 100, 900, new_tokens, seed=args.seed + 2,
                         gap=0.1)
    moves = []
    migrate = timed_migrations(tfm, cfg, moves, [0])
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
        f"({sig['expert_moves']} expert moves), wall ms and peak rise MiB "
        f"of each move {each_move(moves)}, kv_peak {kv_peak:.4f} "
        f"(peak token occupancy of the dense caches in the engines' traces; "
        f"the cluster's own kv_peak reads page pools: "
        f"{sig['kv_peak']:.4f}), dense caches {cache_mib:.1f} MiB in all; "
        f"launches {launches}, on the tensor cores {tc}")
    del res, engines

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
        f"(the weights, moved in place, with the prefetch's staged rows "
        f"beside them)")

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


def llama4_moe_layer_check(cfg, params):
    """The full-width MoE layer through the kernels (bf16) against a plain
    f32 computation of the same function on the card, for 8 tokens: each
    token's routed expert and the shared expert, the weights read row by
    row. Within the bf16 bar (3e-2)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_route import ROW_TOL, row_rel_err
    from repro_torch.models import moe as moe_mod
    lp = {k: (v[0] if not isinstance(v, dict) else
              {n: w[0] for n, w in v.items()})
          for k, v in params["blocks"]["pos1"]["moe"].items()}
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(8, 1, cfg.d_model, generator=g, device="cuda") \
        .to(torch.bfloat16)
    placement = torch.arange(cfg.moe.n_experts, dtype=torch.int32,
                             device="cuda")
    y, _ = moe_mod.moe_layer(lp, cfg, x, placement, collect_stats=False)
    gates, idx, _ = moe_mod.route(lp, cfg, x)
    xf = x[:, 0].float()
    ref = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for k in range(cfg.moe.top_k):
            e = int(idx[t, 0, k])
            h = F.silu(xf[t] @ lp["w_gate"][e].float()) \
                * (xf[t] @ lp["w_up"][e].float())
            ref[t] += float(gates[t, 0, k]) * (h @ lp["w_down"][e].float())
    sh = lp["shared"]
    h = F.silu(xf @ sh["w_gate"].float()) * (xf @ sh["w_up"].float())
    ref += h @ sh["w_down"].float()
    err, rel = max_err(y[:, 0], ref), row_rel_err(y[:, 0], ref)
    if not torch.isfinite(y).all() or rel > ROW_TOL[torch.bfloat16]:
        raise AssertionError(f"llama4 MoE layer at full width: row_rel_err "
                             f"{rel} against the f32 computation (tolerance "
                             f"{ROW_TOL[torch.bfloat16]})")
    log(f"llama4: the full-width MoE layer (8 tokens, top-1 of 128 experts "
        f"of 5120 -> 8192 -> 5120, and the shared expert) through the "
        f"kernels in bf16 against an f32 computation on the card: each "
        f"token's row within {rel:.3g} of its norm (tolerance "
        f"{ROW_TOL[torch.bfloat16]:g}: a few bf16 roundings of a row), "
        f"max_abs_err {err:.3g} for |y| up to {float(ref.abs().max()):.3g}")


def llama4_serve_phase(args, counters):
    """llama4-maverick at full width (d 5120, 40/8 heads of 128, vocab
    202048, 128 experts top-1 of 8192, one shared expert of 8192, a dense
    FFN of 16384), depth cut 48 -> 2 (one period: a dense layer and a MoE
    layer), bf16, with random weights from ``--seed``: 16 requests with
    prompts of 128 to 1024 tokens and 32 new tokens each, arriving over
    time, through serve_real_cluster on two PagedRealEngines sharing one
    runner, int8 KV pages, the Gimbal scheduler and an uncalibrated
    placement (experts migrate), profiled on the device. Every adoption of
    a placement moves the experts in place: its peak memory rise must stay
    within the moved experts' bytes plus 64 MiB."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import PlacementConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import PagedEngineConfig
    full = get_config("llama4-maverick-400b-a17b")
    cfg = reduced(full, n_layers=2)
    m = cfg.moe
    log(f"llama4: reduced n_layers {full.n_layers}→{cfg.n_layers} (one "
        f"period: a dense FFN of {cfg.d_ff}, then {m.n_experts} experts "
        f"top-{m.top_k} of {m.d_expert} and {m.n_shared_experts} shared of "
        f"{m.d_shared}; width unchanged: d={cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, hd={cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}); {cfg.param_count() * 2 / 2**30:.2f} "
        f"GiB of weights by ModelConfig.param_count()")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = tfm.init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    after_init = torch.cuda.memory_allocated()
    log(f"llama4: init of random weights from seed {args.seed} on the card "
        f"in {time.perf_counter() - t0:.1f} s: "
        f"{(after_init - base) / 2**30:.2f} GiB allocated, init peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB "
        f"({after_init / 2**30:.2f} GiB on the card in all)")
    llama4_moe_layer_check(cfg, params)
    ecfg = PagedEngineConfig(page_size=16, n_pages=1024,
                             max_blocks_per_req=72, max_batch=8,
                             token_budget=512,
                             chunk_buckets=(64, 128, 256, 512),
                             kv_dtype="int8", device="cuda")
    new_tokens = 32
    before = weight_fingerprint(params)
    adoptions, peak, forwards, got = [], [0], [0], {}

    def run():
        # a new serve, counted afresh, each time the profile is taken
        forwards[0] = 0
        adoptions.clear()
        reset_counts(counters)
        reqs = make_requests(cfg, 16, 128, 1024, new_tokens,
                             seed=args.seed + 3, gap=0.1)
        res, engines, wall = serve_cluster(
            cfg, params, ecfg, reqs, window_tokens=1024,
            placement_cfg=PlacementConfig.uncalibrated())
        got.update(res=res, wall=wall, reqs=reqs)
        return (f"{res.signals['rounds']} rounds, {forwards[0]} forward "
                "passes")

    torch.cuda.reset_peak_memory_stats()
    migrate = timed_migrations(tfm, cfg, adoptions, peak)
    restore = counted_forwards(tfm, forwards)
    try:
        profile_until_complete("llama4_serve", run, lambda rows: (
            profile_write_and_stats(rows, forwards[0] * cfg.n_layers,
                                    forwards[0] * cfg.n_moe_layers,
                                    "llama4_serve")))
    finally:
        restore()
        tfm.migrate_params_for_placement = migrate
    launches, tc = read_counts(counters)
    torch.cuda.synchronize()
    peak[0] = max(peak[0], torch.cuda.max_memory_allocated())

    reqs, res, sig = got["reqs"], got["res"], got["res"].signals
    bad = [r.req_id for r in reqs if r.error or r.finish_time < 0
           or len(r.full_output_tokens) != new_tokens
           or not all(0 <= t < cfg.vocab_size for t in r.full_output_tokens)]
    if bad or sig["unfinished"]:
        raise AssertionError(f"llama4_serve: requests {bad} did not finish "
                             f"with a full in-vocabulary stream "
                             f"({sig['errors']})")
    if sig["migrations"] <= 0 or not adoptions:
        raise AssertionError("llama4_serve: no placement was adopted, so no "
                             "expert weights moved on the card")
    if min(sig["per_engine"].values()) <= 0:
        raise AssertionError(f"llama4_serve: an engine served nothing "
                             f"({sig['per_engine']})")
    for name in ("paged_decode", "moe_gmm_ragged", "source_expert_count",
                 "pack_kv", "unpack_kv"):        # the paged path's five
        if launches[name] <= 1:
            raise AssertionError(f"llama4_serve: kernel {name} launched "
                                 f"{launches[name]} times")
    check_routes("llama4_serve", launches, tc,
                 ("moe_gmm_ragged", "paged_decode"))
    slack = 64 << 20
    for i, a in enumerate(adoptions):
        if a["rise"] > a["bytes"] + slack:
            raise AssertionError(f"llama4_serve: adoption {i} raised the "
                                 f"peak by {a['rise']} bytes for {a['rows']} "
                                 f"moved experts ({a['bytes']} bytes) + 64 "
                                 f"MiB")
    if not all(torch.equal(a, b) for a, b in
               zip(before, weight_fingerprint(params))):
        raise AssertionError("llama4_serve: the serve changed the caller's "
                             "weights")
    prompt = sum(r.prompt_len for r in reqs)
    gen_tok = sum(len(r.full_output_tokens) for r in reqs)
    log(f"llama4_serve: {len(reqs)}/{len(reqs)} requests arriving over "
        f"{reqs[-1].arrival_time:.1f} virtual s served through "
        f"serve_real_cluster on 2 engines with int8 KV pages at full width "
        f"({cfg.n_layers} layers): {sig['rounds']} rounds, {prompt} prompt + "
        f"{gen_tok} generated tokens in {got['wall']:.2f} s wall (profiled), "
        f"on {torch.cuda.get_device_name(0)}")
    log(f"llama4_serve: decisions {sig['decisions']}, per engine "
        f"{sig['per_engine']}, {sig['migrations']} placements adopted "
        f"({sig['expert_moves']} expert moves), kv_peak "
        f"{sig['kv_peak']:.4f}; launches {launches}, on the tensor cores {tc}")
    for i, a in enumerate(adoptions):
        log(f"llama4_serve: adoption {i}: {a['s'] * 1e3:.1f} ms wall, "
            f"{a['rows']} expert rows moved in place = "
            f"{a['bytes'] / 2**20:.0f} MiB, peak rise "
            f"{a['rise'] / 2**20:.1f} MiB (bound: the moved bytes + 64 MiB)")
    log(f"llama4_serve: card memory after init {after_init / 2**30:.2f} GiB, "
        f"serve peak {peak[0] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); the caller's weights unchanged "
        f"after the serve (per-expert fingerprints equal)")
    return launches, tc


# ------------------------------------------------------------ dense families
DENSE_PAGED = dict(page_size=16, n_pages=1024, max_blocks_per_req=72,
                   max_batch=8, token_budget=512,
                   chunk_buckets=(64, 128, 256, 512))


def init_family(cfg, seed, label, phase="dense_families"):
    """Random bf16 weights of ``cfg`` from ``seed`` on the card, through
    ``build_model``'s ``init``, logged."""
    from repro_torch.models import build_model
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    log(f"{phase}: {label}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} of hd={cfg.head_dim}, d_ff="
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{cfg.param_count() * 2 / 2**30:.2f} GiB by param_count(), "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB "
        f"allocated from seed {seed} in {time.perf_counter() - t0:.1f} s "
        f"(init peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f}"
        f" GiB)")
    return params


def family_serve(label, cfg, reqs, counters, run, needed, mains=(),
                 cuda_cores=(), phase="dense_families"):
    """One ``serve_real_cluster`` of the dense families, the counts set to 0
    just before and read just after: every request finished with a full
    in-vocabulary stream, both engines served, nothing migrated (no
    experts), each kernel of ``needed`` launched, the routes as
    ``check_routes`` holds them. ``run()`` -> (SimResult, engines, wall s).
    Returns (launches, tensor-core launches)."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    res, _, wall = run()
    launches, tc = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    sig = res.signals
    new = reqs[0].max_new_tokens
    bad = [r.req_id for r in reqs if r.error or r.finish_time < 0
           or len(r.full_output_tokens) != new
           or not all(0 <= t < cfg.vocab_size for t in r.full_output_tokens)]
    if bad or sig["unfinished"]:
        raise AssertionError(f"{phase}: {label}: requests {bad} did "
                             f"not finish with a full in-vocabulary stream "
                             f"({sig['errors']})")
    if min(sig["per_engine"].values()) <= 0:
        raise AssertionError(f"{phase}: {label}: an engine served "
                             f"nothing ({sig['per_engine']})")
    if sig["migrations"] or sig["expert_moves"]:
        raise AssertionError(f"{phase}: {label}: a model without "
                             f"experts migrated ({sig['migrations']})")
    for name in needed:
        if launches[name] <= 0:
            raise AssertionError(f"{phase}: {label}: kernel {name} "
                                 "was not launched")
    check_routes(f"{phase}: {label}", launches, tc, mains, cuda_cores)
    prompt = sum(r.prompt_len for r in reqs)
    gen_tok = sum(len(r.full_output_tokens) for r in reqs)
    log(f"{phase}: {label}: {len(reqs)}/{len(reqs)} requests "
        f"({prompt} prompt + {gen_tok} generated tokens) through "
        f"serve_real_cluster on 2 engines in {wall:.2f} s wall, "
        f"{sig['rounds']} rounds; Algorithm-1 decisions {sig['decisions']}, "
        f"per engine {sig['per_engine']}; launches "
        f"{ {n: launches[n] for n in needed} }, routes "
        f"{ {n: route_name(tc[n]) for n in needed if n in tc} }; peak "
        f"memory {peak / 2**30:.2f} GiB")
    return launches, tc


def decode_run(fns, params, batch, cache, toks, start, **kw):
    """prefill ``batch`` into ``cache``, then one decode step for each row
    of ``toks`` (steps, B) at positions ``start``, ``start`` + 1, ...;
    returns the stacked logits (steps + 1, B, V)."""
    B = toks.shape[1]
    lg, cache, _ = fns.prefill(params, batch, cache)
    out = [lg]
    for i in range(toks.shape[0]):
        lg, cache, _ = fns.decode(params, toks[i], cache, torch.full(
            (B,), start + i, dtype=torch.int32, device=toks.device), **kw)
        out.append(lg)
    return torch.stack(out)


def qwen15_entry_points(args, cfg, params, counters):
    """qwen1.5-32b through ``build_model``'s entry points: prefill of 8
    prompts of 1024 tokens into a (8, 2048) cache, then 32 decode steps of
    the same random tokens, once with a bf16 cache and once with an int8
    cache. The two runs' logits meet the reference's bar
    (``hold_to_bar``) at every step. Returns the int8 run's (launches,
    tensor-core launches)."""
    from repro_torch.models import build_model
    fns = build_model(cfg)
    B, S, L, steps = 8, 1024, 2048, 32
    rng = np.random.default_rng(args.seed + 7)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, B)),
                           dtype=torch.int32, device="cuda")
    batch = {"tokens": prompt,
             "lengths": torch.full((B,), S, dtype=torch.int32,
                                   device="cuda")}
    logits, counts = {}, {}
    for kvd in ("bfloat16", "int8"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        t0 = time.perf_counter()
        cache = fns.init_cache(B, L, kv_dtype=kvd, device="cuda")
        cache_gib = sum(t.numel() * t.element_size() for c in cache.values()
                        for t in c.values()) / 2**30
        logits[kvd] = decode_run(fns, params, batch, cache, toks, S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, tc = read_counts(counters)
        counts[kvd] = (launches, tc)
        del cache
        if tuple(logits[kvd].shape) != (steps + 1, B, cfg.vocab_size) or \
                not torch.isfinite(logits[kvd]).all():
            raise AssertionError(f"qwen1.5-32b ({kvd} cache): logits not "
                                 "finite or of the wrong shape")
        writes = (steps + 1) * cfg.n_layers if kvd == "int8" else 0
        if launches["flash_decode"] != steps * cfg.n_layers or \
                launches["pack_kv"] != writes:
            raise AssertionError(f"qwen1.5-32b ({kvd} cache): launches "
                                 f"{launches}; expected flash_decode "
                                 f"{steps * cfg.n_layers}, pack_kv {writes}")
        check_routes(f"dense_families: qwen1.5-32b entry points ({kvd})",
                     launches, tc, ("flash_decode",))
        log(f"dense_families: qwen1.5-32b entry points, {kvd} cache of "
            f"{cache_gib:.2f} GiB: prefill of {B} x {S} tokens and {steps} "
            f"decode steps in {wall:.2f} s wall, flash_decode launches "
            f"{launches['flash_decode']} ({route_name(tc['flash_decode'])}), "
            f"pack_kv {launches['pack_kv']} (one ring write a layer and "
            f"call); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    hold_to_bar("dense_families", f"qwen1.5-32b: int8 against bf16 cache "
                f"over the {steps + 1} logits", logits["int8"],
                logits["bfloat16"])
    return counts["int8"]


def dense_families_twins():
    """Float32 twins of the four families at their smoke sizes through
    ``serve_real_cluster`` on the card and on the CPU: two dense engines
    each (the gemmas' 16-slot local rings overflowed by the prompts), and
    two paged engines on int8 pages for the two qwens; the same tokens and
    signals on both."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import PagedEngineConfig
    keys = ("decisions", "per_engine", "unfinished", "migrations", "rounds")
    for arch in ("qwen3-8b", "qwen1.5-32b", "gemma2-2b", "gemma3-12b"):
        cfg = reduced(get_smoke_config(arch), dtype="float32")
        params = tfm.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        params_gpu = tree_map(lambda t: t.to("cuda"), params)
        planes = ["dense"] + (["paged int8"] if arch.startswith("qwen")
                              else [])
        for plane in planes:
            out = {}
            for dev, p in (("cpu", params), ("cuda", params_gpu)):
                reqs = make_requests(cfg, 8, 6, 30, 5, seed=7, gap=0.1)
                if plane == "dense":
                    res = serve_dense_cluster(cfg, p, reqs, device=dev,
                                              ragged=True, max_slots=4,
                                              max_len=64)[0]
                else:
                    ecfg = PagedEngineConfig(
                        page_size=8, n_pages=48, max_blocks_per_req=8,
                        max_batch=4, token_budget=16, chunk_buckets=(8, 16),
                        kv_dtype="int8", device=dev)
                    res = serve_cluster(cfg, p, ecfg, reqs)[0]
                out[dev] = ([r.full_output_tokens for r in reqs],
                            {k: res.signals[k] for k in keys})
            (toks_c, sig_c), (toks_g, sig_g) = out["cpu"], out["cuda"]
            if toks_c != toks_g or sig_c != sig_g or sig_g["unfinished"]:
                diff = [k for k in keys if sig_c[k] != sig_g[k]]
                raise AssertionError(f"float32 twin {arch} ({plane}): card "
                                     f"and CPU disagree (tokens equal: "
                                     f"{toks_c == toks_g}; signals that "
                                     f"differ: {diff})")
            log(f"dense_families: float32 twin {arch} ({plane}): card "
                f"kernels and CPU plain versions give the same "
                f"{sum(map(len, toks_c))} tokens, decisions "
                f"{sig_g['decisions']}, {sig_g['rounds']} rounds")


def dense_families_phase(args, counters):
    """The dense families at full width on the card, each family's weights
    freed before the next: qwen3-8b (36 layers) through serve_real_cluster
    over two paged engines on bf16 pages, then on int8 pages, then over two
    dense engines; gemma3-12b (48 layers, 5 local layers of window 1024 to
    1 global, hd 256) and gemma2-2b (26 layers, softcaps 50 and 30, hd 256)
    over two dense engines of 2048 tokens a slot, where ``flash_decode``
    takes the CUDA cores (half of gemma3's serve again, profiled);
    qwen1.5-32b at full width and 32 of its 64 layers
    through ``build_model``'s entry points with bf16 and int8 caches, then
    over two dense engines; then the float32 twins. Returns the phase's
    summed (launches, tensor-core launches)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import PagedEngineConfig
    total, total_tc = {}, {}

    def add(counts):
        for acc, c in zip((total, total_tc), counts):
            for k, v in c.items():
                acc[k] = acc.get(k, 0) + v

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cfg = get_config("qwen3-8b")
    params = init_family(cfg, args.seed, "qwen3-8b")
    for kv in ("auto", "int8"):
        ecfg = PagedEngineConfig(**DENSE_PAGED, kv_dtype=kv, device="cuda")
        reqs = make_requests(cfg, 8, 256, 1024, 32, seed=args.seed + 5,
                             gap=0.1)
        needed = ("paged_decode",) + (("pack_kv", "unpack_kv")
                                      if kv == "int8" else ())
        add(family_serve(
            f"qwen3-8b, paged {'int8' if kv == 'int8' else 'bf16'} pages",
            cfg, reqs, counters,
            lambda: serve_cluster(cfg, params, ecfg, reqs), needed,
            mains=("paged_decode",)))
    reqs = make_requests(cfg, 8, 256, 1024, 32, seed=args.seed + 5, gap=0.1)
    add(family_serve(
        "qwen3-8b, dense caches (8 slots x 1088)", cfg, reqs, counters,
        lambda: serve_dense_cluster(cfg, params, reqs, device="cuda",
                                    ragged=True, max_slots=8,
                                    max_len=1088)[:3],
        ("flash_decode",), mains=("flash_decode",)))
    del params
    free()

    for arch in ("gemma3-12b", "gemma2-2b"):
        cfg = get_config(arch)
        params = init_family(cfg, args.seed, arch)

        def gemma_reqs(n=8, new=64):
            return make_requests(cfg, n, 900, 1400, new, seed=args.seed + 6,
                                 gap=0.1)

        def gemma_serve(reqs):
            return serve_dense_cluster(cfg, params, reqs, device="cuda",
                                       ragged=True, max_slots=8,
                                       max_len=2048)[:3]

        reqs = gemma_reqs()
        rings = sorted({min(cfg.sliding_window, 2048) if cfg.is_local_layer(j)
                        else 2048 for j in range(cfg.n_layers)})
        if arch == "gemma3-12b" and not (
                rings[0] == 1024 and any(r.prompt_len > 1024 for r in reqs)):
            raise AssertionError("gemma3-12b: expected 1024-slot local rings "
                                 "that a prompt overflows")
        add(family_serve(
            f"{arch}, dense caches (8 slots x 2048; cache rows of {rings} "
            f"slots)", cfg, reqs, counters, lambda: gemma_serve(reqs),
            ("flash_decode",), cuda_cores=("flash_decode",)))
        if arch == "gemma3-12b":
            # hd 256 decode on the CUDA cores, in a serve of half the
            # requests and new tokens: on an H100 the profiler took minutes
            # to aggregate the whole serve's 0.6 M kernel events
            profiled("dense_families gemma3-12b (2 requests, 16 new)",
                     lambda: "{} rounds".format(gemma_serve(gemma_reqs(
                         2, 16))[0].signals["rounds"]))
        del params
        free()

    full = get_config("qwen1.5-32b")
    cfg = reduced(full, n_layers=32)
    full_gib = full.param_count() * 2 / 2**30
    log(f"dense_families: qwen1.5-32b: reduced n_layers {full.n_layers}→"
        f"{cfg.n_layers} (width unchanged; {full_gib:.1f} GiB of bf16 "
        f"weights at full depth do not fit one 80 GB card)")
    params = init_family(cfg, args.seed, "qwen1.5-32b")
    add(qwen15_entry_points(args, cfg, params, counters))
    free()
    reqs = make_requests(cfg, 8, 256, 1024, 32, seed=args.seed + 8, gap=0.1)
    add(family_serve(
        "qwen1.5-32b, dense caches (8 slots x 1088)", cfg, reqs, counters,
        lambda: serve_dense_cluster(cfg, params, reqs, device="cuda",
                                    ragged=True, max_slots=8,
                                    max_len=1088)[:3],
        ("flash_decode",), mains=("flash_decode",)))
    del params
    free()
    dense_families_twins()
    return total, total_tc


# ------------------------------------------------------------ other families
OF = "other_families"


def step_line(label, wall, counters):
    """One step's line: wall time, peak memory since the last reset, and
    the kernel launches by route since the counts were set to 0."""
    launches, tc = read_counts(counters)
    used = {n: v for n, v in launches.items() if v}
    routes = {n: f"{tc[n]} tensor cores, {launches[n] - tc[n]} CUDA cores"
              for n in used if n in tc}
    log(f"{OF}: {label}: {wall:.2f} s wall, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{used or 'none'}" + (f" ({routes})" if routes else ""))
    return launches, tc


def hold_to_bar(phase, label, got, ref):
    """The reference's bar between two logit sets
    (``tests/test_models.py::test_int8_kv_cache_close_to_bf16``): max |got -
    ref| < 0.05 * max |ref| + 0.05. Logged; raises when it fails."""
    if tuple(got.shape) != tuple(ref.shape) or \
            not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{phase}: {label}: logits not finite or of "
                             f"different shapes {tuple(got.shape)}, "
                             f"{tuple(ref.shape)}")
    diff = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if not diff < 0.05 * scale + 0.05:
        raise AssertionError(f"{phase}: {label}: max |diff| {diff} >= 0.05 "
                             f"* {scale} + 0.05")
    log(f"{phase}: {label}: max |diff| {diff:.4f} < 0.05 * max|ref| + 0.05 "
        f"= {0.05 * scale + 0.05:.4f} (the reference's bar)")


def llava_entry_points(args, cfg, params, counters):
    """llava-next-34b through ``build_model``'s entry points: prefill of 4
    sequences of 2880 stand-in patch embeddings (LLaVA-NeXT's any-resolution
    maximum: a base image and four tiles of 576 patches) into a (4, 4096)
    cache, then 32 decode steps of random tokens, with a bf16 and an int8
    cache, held to each other at the reference's bar; then the bf16 run's
    first decode step against a prefill of the 2880 embeddings and the
    embedded token (2881 rows). Returns the int8 run's counts."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import embed_tokens
    fns = build_model(cfg)
    B, S, L, steps = 4, 2880, 4096, 32
    g = torch.Generator(device="cuda").manual_seed(args.seed + 9)
    # at the scale of the token embeddings (embed_init: 0.02 * N(0, 1))
    emb = (torch.randn(B, S, cfg.d_model, generator=g, device="cuda")
           * 0.02).to(torch.bfloat16)
    rng = np.random.default_rng(args.seed + 9)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, B)),
                           dtype=torch.int32, device="cuda")
    batch = {"embeddings": emb,
             "lengths": torch.full((B,), S, dtype=torch.int32,
                                   device="cuda")}
    logits, counts = {}, {}
    for kvd in ("bfloat16", "int8"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        t0 = time.perf_counter()
        cache = fns.init_cache(B, L, kv_dtype=kvd, device="cuda")
        logits[kvd] = decode_run(fns, params, batch, cache, toks, S)
        torch.cuda.synchronize()
        del cache
        counts[kvd] = step_line(
            f"llava-next-34b entry points, {kvd} cache: prefill of {B} x "
            f"{S} patch embeddings, {steps} decode steps",
            time.perf_counter() - t0, counters)
        launches, tc = counts[kvd]
        writes = (steps + 1) * cfg.n_layers if kvd == "int8" else 0
        if launches["flash_decode"] != steps * cfg.n_layers or \
                launches["pack_kv"] != writes:
            raise AssertionError(f"{OF}: llava ({kvd} cache): launches "
                                 f"{launches}; expected flash_decode "
                                 f"{steps * cfg.n_layers}, pack_kv {writes}")
        check_routes(f"{OF}: llava entry points ({kvd})", launches, tc,
                     ("flash_decode",))
    hold_to_bar(OF, "llava-next-34b, int8 against bf16 cache over the "
                f"{steps + 1} logits", logits["int8"], logits["bfloat16"])
    t0 = time.perf_counter()
    longer = torch.cat([emb, embed_tokens(params["embed"], cfg,
                                          toks[0][:, None])], dim=1)
    lg, _, _ = fns.prefill(params, {"embeddings": longer},
                           fns.init_cache(B, L, device="cuda"))
    torch.cuda.synchronize()
    hold_to_bar(OF, f"llava-next-34b, decode after {S} embeddings against "
                f"a prefill of {S + 1} rows ({time.perf_counter() - t0:.2f} "
                f"s)", logits["bfloat16"][1], lg)
    return counts["int8"]


def hymba_entry_points(args, cfg, params, counters):
    """hymba-1.5b through ``build_model``: at B = 2, one decode after a
    prefill of 1199 tokens against a prefill of 1200 (the mamba state and
    the 1024-slot rings across the boundary); then the wall time of one
    prompt's prefill (B = 1, 1400 tokens) and of its mamba branches."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    fns = build_model(cfg)
    B, S, L = 2, 1200, 2048
    rng = np.random.default_rng(args.seed + 10)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           dtype=torch.int32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    lg = decode_run(fns, params, {"tokens": toks[:, :S - 1]},
                    fns.init_cache(B, L, device="cuda"),
                    toks[:, S - 1][None], S - 1)[1]
    full, _, _ = fns.prefill(params, {"tokens": toks},
                             fns.init_cache(B, L, device="cuda"))
    torch.cuda.synchronize()
    launches, tc = step_line(f"hymba-1.5b entry points: prefill {B} x "
                             f"{S - 1} and one decode, prefill {B} x {S}",
                             time.perf_counter() - t0, counters)
    if launches["flash_decode"] != cfg.n_layers:
        raise AssertionError(f"{OF}: hymba: {launches['flash_decode']} "
                             f"flash_decode launches, {cfg.n_layers} expected")
    check_routes(f"{OF}: hymba entry points", launches, tc, ("flash_decode",))
    hold_to_bar(OF, f"hymba-1.5b, decode after {S - 1} tokens against a "
                f"prefill of {S}", lg, full)
    # the prefill of one prompt, and the share of its mamba branches
    mamba_s = [0.0]
    block = tfm.mamba_block

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = block(*a, **kw)
        torch.cuda.synchronize()
        mamba_s[0] += time.perf_counter() - t
        return out

    one = toks[:1].repeat(1, 2)[:, :1400]
    tfm.mamba_block = timed
    try:
        t0 = time.perf_counter()
        fns.prefill(params, {"tokens": one},
                    fns.init_cache(1, L, device="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tfm.mamba_block = block
    log(f"{OF}: hymba-1.5b prefill of one 1400-token prompt: {wall:.2f} s "
        f"wall, of which the {cfg.n_layers} mamba branches {mamba_s[0]:.2f} "
        f"s (a sequential scan of 1400 steps each, plain PyTorch)")
    return launches, tc


def xlstm_entry_points(args, cfg, params):
    """xlstm-125m through ``build_model``: at B = 4, one decode after a
    prefill of 511 tokens (its last 128-token chunk padded) against a
    prefill of 512; then the reference-side fact of the dense engine:
    the splice of a prefilled state into its slot writes no leaf."""
    from repro_torch.bridge import tree_leaves
    from repro_torch.models import build_model
    from repro_torch.serving import RealModelEngine, Request
    fns = build_model(cfg)
    B, S = 4, 512
    rng = np.random.default_rng(args.seed + 11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    lg = decode_run(fns, params, {"tokens": toks[:, :S - 1]},
                    fns.init_cache(B, 0, device="cuda"),
                    toks[:, S - 1][None], S - 1)[1]
    full, _, _ = fns.prefill(params, {"tokens": toks},
                             fns.init_cache(B, 0, device="cuda"))
    torch.cuda.synchronize()
    log(f"{OF}: xlstm-125m entry points: prefill {B} x {S - 1} and one "
        f"decode, prefill {B} x {S}: {time.perf_counter() - t0:.2f} s")
    hold_to_bar(OF, f"xlstm-125m, decode after {S - 1} tokens against a "
                f"prefill of {S}", lg, full)
    eng = RealModelEngine(0, cfg, params, max_slots=8, max_len=1088,
                          device="cuda")
    before = [t.clone() for t in tree_leaves(eng.cache)]
    prompt = toks[0].tolist()
    eng.enqueue(Request(req_id=0, prompt_len=S, max_new_tokens=2,
                        arrival_time=0.0, prompt_tokens=prompt), 0.0)
    eng._admit(0.0)
    spliced = sum(not torch.equal(a, b)
                  for a, b in zip(before, tree_leaves(eng.cache)))
    _, own, _ = fns.prefill(params, {"tokens": toks[:1]},
                            fns.init_cache(1, 0, device="cuda"))
    own_c = float(own[0]["C"].abs().sum())
    log(f"{OF}: xlstm-125m: the dense engine spliced {spliced} of "
        f"{len(before)} state leaves of a {S}-token prefill into its slot "
        f"(the prefill's own block-0 sum|C| = {own_c:.1f}): the reference's "
        f"rule writes only leaves whose leading size matches, and xLSTM's "
        f"(batch, ...) states do not (ROADMAP.md Queue C)")
    if spliced or not own_c > 0:
        raise AssertionError(f"{OF}: xlstm: expected no spliced leaf and a "
                             f"non-zero prefill state ({spliced}, {own_c})")


def seamless_entry_points(args, cfg, params):
    """seamless-m4t-large-v2 through ``build_model``: prefill of 4
    sequences of 1024 stand-in frames and a 32-token decoder prompt into a
    cache of 1024 slots, then 32 decode steps with ``enc_lengths`` 1024;
    the first decode step against a decoder prefill one token longer."""
    from repro_torch.models import build_model
    fns = build_model(cfg)
    B, S_src, S, L, steps = 4, 1024, 32, 1024, 32
    g = torch.Generator(device="cuda").manual_seed(args.seed + 12)
    frames = torch.randn(B, S_src, cfg.d_model, generator=g,
                         device="cuda").to(torch.bfloat16)
    rng = np.random.default_rng(args.seed + 12)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)),
                             dtype=torch.int32, device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, B)),
                           dtype=torch.int32, device="cuda")
    toks[0] = prompt[:, S]
    enc_lengths = torch.full((B,), S_src, dtype=torch.int32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = fns.init_cache(B, L, device="cuda")
    lg = decode_run(fns, params, {"embeddings": frames,
                                  "tokens": prompt[:, :S]}, cache, toks, S,
                    enc_lengths=enc_lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cache_gib = sum(t.numel() * t.element_size()
                    for t in cache.values()) / 2**30
    del cache
    if tuple(lg.shape) != (steps + 1, B, cfg.vocab_size) or \
            not torch.isfinite(lg).all():
        raise AssertionError(f"{OF}: seamless: logits not finite or of "
                             f"shape {tuple(lg.shape)}")
    log(f"{OF}: seamless-m4t-large-v2 entry points: encoder over {B} x "
        f"{S_src} frames, decoder prefill of {B} x {S}, {steps} decode "
        f"steps with enc_lengths {S_src}: {wall:.2f} s wall, a {cache_gib:.2f}"
        f" GiB cache, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    full, _, _ = fns.prefill(params, {"embeddings": frames,
                                      "tokens": prompt},
                             fns.init_cache(B, L, device="cuda"))
    hold_to_bar(OF, f"seamless-m4t-large-v2, decode after a {S}-token "
                f"prompt against a decoder prefill of {S + 1}", lg[1], full)


def other_families_twins():
    """Float32 twins of the four families at their smoke sizes, card against
    CPU: the entry points (prefill, then 4 decode steps; llava from
    embeddings, hymba past its 16-slot ring, xlstm past its 16-token chunk,
    seamless with encoder lengths) within 1e-4; for llava, hymba and xlstm,
    ``serve_real_cluster`` over two dense engines with the same tokens and
    Algorithm-1 decisions on both."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.models import build_model
    keys = ("decisions", "per_engine", "unfinished", "migrations", "rounds")
    for arch in ("llava-next-34b", "hymba-1.5b", "xlstm-125m",
                 "seamless-m4t-large-v2"):
        cfg = reduced(get_smoke_config(arch), dtype="float32")
        fns = build_model(cfg)
        params = fns.init(torch.Generator().manual_seed(0), device="cpu")
        params_gpu = tree_map(lambda t: t.to("cuda"), params)
        rng = np.random.default_rng(3)
        B, S, steps = 2, 27, 4
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.int32)}
        kw = {}
        if cfg.input_mode == "embeddings":
            batch["embeddings"] = torch.as_tensor(
                rng.normal(size=(B, S, cfg.d_model)), dtype=torch.float32)
            if cfg.family == "encdec":
                kw["enc_lengths"] = torch.tensor([S - 5, S],
                                                 dtype=torch.int32)
            else:
                del batch["tokens"]
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, B)),
                               dtype=torch.int32)
        out = {}
        for dev, p in (("cpu", params), ("cuda", params_gpu)):
            out[dev] = decode_run(
                fns, p, {k: v.to(dev) for k, v in batch.items()},
                fns.init_cache(B, 48, device=dev), toks.to(dev), S,
                **{k: v.to(dev) for k, v in kw.items()}).cpu()
        err = max_err(out["cuda"], out["cpu"])
        if not err <= TOL["float32"]:
            raise AssertionError(f"{OF}: float32 twin {arch}: card and CPU "
                                 f"logits differ by {err}")
        line = (f"{OF}: float32 twin {arch}: entry points card against CPU, "
                f"max |diff| {err:.2e} over {steps + 1} logit sets")
        if cfg.family != "encdec":
            sv = {}
            for dev, p in (("cpu", params), ("cuda", params_gpu)):
                reqs = make_requests(cfg, 8, 6, 30, 5, seed=7, gap=0.1)
                res = serve_dense_cluster(cfg, p, reqs, device=dev,
                                          ragged=True, max_slots=4,
                                          max_len=64)[0]
                sv[dev] = ([r.full_output_tokens for r in reqs],
                           {k: res.signals[k] for k in keys})
            (toks_c, sig_c), (toks_g, sig_g) = sv["cpu"], sv["cuda"]
            if toks_c != toks_g or sig_c != sig_g or sig_g["unfinished"]:
                diff = [k for k in keys if sig_c[k] != sig_g[k]]
                raise AssertionError(f"{OF}: float32 twin {arch} (dense "
                                     f"cluster): card and CPU disagree "
                                     f"(tokens equal: {toks_c == toks_g}; "
                                     f"signals that differ: {diff})")
            line += (f"; serve_real_cluster over two dense engines gives the "
                     f"same {sum(map(len, toks_c))} tokens, decisions "
                     f"{sig_g['decisions']}, {sig_g['rounds']} rounds")
        log(line)


def other_families_phase(args, counters):
    """The other four families at full width on the card, each family's
    weights freed before the next: llava-next-34b at 30 of its 60 layers
    (entry points from patch embeddings with bf16 and int8 caches, then two
    dense engines); hymba-1.5b (two dense engines of 2048 tokens a slot,
    prompts that overflow the 1024-slot rings, then the entry points);
    xlstm-125m (entry points, the splice fact, two dense engines);
    seamless-m4t-large-v2 (entry points); then the float32 twins. Returns
    the phase's summed (launches, tensor-core launches)."""
    from repro_torch.configs import get_config, reduced
    total, total_tc = {}, {}

    def add(counts):
        for acc, c in zip((total, total_tc), counts):
            for k, v in c.items():
                acc[k] = acc.get(k, 0) + v

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def dense_serve(label, cfg, params, reqs, max_len, needed):
        add(family_serve(
            f"{label}, dense caches (8 slots x {max_len})", cfg, reqs,
            counters, lambda: serve_dense_cluster(
                cfg, params, reqs, device="cuda", ragged=True, max_slots=8,
                max_len=max_len)[:3], needed, mains=needed, phase=OF))

    full = get_config("llava-next-34b")
    cfg = reduced(full, n_layers=30)
    log(f"{OF}: llava-next-34b: reduced n_layers {full.n_layers}→"
        f"{cfg.n_layers} (width unchanged; "
        f"{full.param_count() * 2 / 2**30:.1f} GiB of bf16 weights at full "
        f"depth do not fit one 80 GB card)")
    params = init_family(cfg, args.seed, "llava-next-34b", OF)
    add(llava_entry_points(args, cfg, params, counters))
    free()
    reqs = make_requests(cfg, 8, 256, 1024, 32, seed=args.seed + 13,
                         gap=0.1)
    dense_serve("llava-next-34b", cfg, params, reqs, 1088, ("flash_decode",))
    del params
    free()

    cfg = get_config("hymba-1.5b")
    params = init_family(cfg, args.seed, "hymba-1.5b", OF)
    rings = sorted({min(cfg.sliding_window, 2048) if cfg.is_local_layer(j)
                    else 2048 for j in range(cfg.n_layers)})
    glob = [j for j in range(cfg.n_layers) if not cfg.is_local_layer(j)]
    reqs = make_requests(cfg, 8, 900, 1400, 32, seed=args.seed + 14,
                         gap=0.1)
    if rings != [1024, 2048] or not any(r.prompt_len > 1024 for r in reqs):
        raise AssertionError(f"{OF}: hymba: expected 1024-slot local rings "
                             f"that a prompt overflows, got {rings}")
    log(f"{OF}: hymba-1.5b: global layers {glob}, the other "
        f"{cfg.n_layers - len(glob)} local with a {rings[0]}-slot ring")
    dense_serve("hymba-1.5b", cfg, params, reqs, 2048, ("flash_decode",))
    add(hymba_entry_points(args, cfg, params, counters))
    del params
    free()

    cfg = get_config("xlstm-125m")
    params = init_family(cfg, args.seed, "xlstm-125m", OF)
    xlstm_entry_points(args, cfg, params)
    reqs = make_requests(cfg, 8, 256, 1024, 32, seed=args.seed + 15,
                         gap=0.1)
    dense_serve("xlstm-125m", cfg, params, reqs, 1088, ())
    del params
    free()

    cfg = get_config("seamless-m4t-large-v2")
    params = init_family(cfg, args.seed, "seamless-m4t-large-v2", OF)
    seamless_entry_points(args, cfg, params)
    del params
    free()
    other_families_twins()
    return total, total_tc


# ------------------------------------------------------------------- train
TR = "train"
DECODE_PATH = ("paged_decode", "flash_decode", "pack_kv", "unpack_kv")


def tree_bytes(tree) -> int:
    from repro_torch.bridge import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree))


def train_steps(label, step_fn, box, batch, n, counters, expected):
    """``n`` steps of ``step_fn`` on ``batch`` from the state in the list
    ``box``, which this empties (a step leaves the state it is given as it
    is, so a reference the caller kept would hold a second train state on
    the card); each step printed (loss, wall, peak memory since the first).
    The counts are set to 0 just before the first step and read just after
    the last. ``expected``: the kernels' launches over the ``n`` steps,
    each held exactly. Returns (state, losses, launches, tensor-core
    launches)."""
    state = box.pop()
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(n):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])           # waits for the step
        wall = time.perf_counter() - t0
        losses.append(loss)
        log(f"{TR}: {label} step {i}: loss {loss:.4f} (ce "
            f"{float(metrics['ce']):.4f}, aux {float(metrics['aux']):.4f}), "
            f"{wall:.2f} s wall, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not np.isfinite(loss):
            raise AssertionError(f"{TR}: {label} step {i}: loss {loss}")
    launches, tc = read_counts(counters)
    for name in counters:
        if launches[name] != expected.get(name, 0):
            raise AssertionError(f"{TR}: {label}: {name} launched "
                                 f"{launches[name]} times in {n} steps, "
                                 f"expected {expected.get(name, 0)}")
    log(f"{TR}: {label}: launches "
        f"{ {k: v for k, v in launches.items() if v} } "
        f"({ {k: v for k, v in tc.items() if launches[k]} } on the tensor "
        f"cores), no decode kernel")
    return state, losses, launches, tc


def twin_diff(arch, what, cpu, card):
    """Max |card - CPU| over two lists of tensors (None where a leaf has no
    gradient), raising past 1e-4; a bf16 leaf (xLSTM's blocks are bf16
    whatever the config's dtype) may also differ by one bf16 unit in the
    last place, as a difference far below 1e-4 can round to the
    neighbouring bf16 value."""
    worst = 0.0
    for a, b in zip(cpu, card):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{TR}: float32 twin {arch}: {what}: a "
                                     f"leaf has a gradient on one side only")
            continue
        d = (a.float() - b.float()).abs()
        bar = TOL["float32"]
        if a.dtype == torch.bfloat16:
            bar = bar + a.float().abs() * 2.0 ** -7
        if not bool((d <= bar).all()):
            raise AssertionError(f"{TR}: float32 twin {arch}: {what}: a leaf "
                                 f"differs by {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def train_twins(args):
    """Float32 twins at smoke size, card against CPU, from the same params
    and batches: the loss and every grad of the first batch, then 3 train
    steps (fp32 moments), every loss and every final param within 1e-4.
    The twins train at lr 1e-4: Adam's update m / (sqrt(v) + eps) turns a
    difference in the last bits of a gradient near 0 into up to 2 lr in
    the param, which at lr 1e-3 passes 1e-4 on xLSTM's twin; the grads
    are held directly."""
    from repro_torch.bridge import tree_flatten, tree_map, tree_unflatten
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.launch.train import make_batch, step_generator
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, make_train_state,
                                   make_train_step)
    for arch, ragged in (("qwen3-moe-30b-a3b", True),
                         ("qwen3-moe-30b-a3b", False), ("qwen3-8b", True),
                         ("gemma2-2b", True), ("hymba-1.5b", True),
                         ("xlstm-125m", True),
                         ("seamless-m4t-large-v2", True)):
        cfg = reduced(get_smoke_config(arch), dtype="float32")
        fns = build_model(cfg)
        params = fns.init(torch.Generator().manual_seed(args.seed),
                          device="cpu")
        ocfg = AdamWConfig(lr=1e-4, moment_dtype="float32")
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            live = [t.detach().requires_grad_() for t in tree_flatten(p)]
            loss, _ = fns.loss(tree_unflatten(p, live), make_batch(
                cfg, 2, 24, step_generator(args.seed, 0), dev),
                ragged=ragged)
            grads = [None if g is None else g.cpu() for g in
                     torch.autograd.grad(loss, live, allow_unused=True)]
            del live
            state = make_train_state(p, ocfg)
            step = make_train_step(
                lambda p, b: fns.loss(p, b, ragged=ragged), ocfg)
            losses = []
            for i in range(3):
                state, m = step(state, make_batch(
                    cfg, 2, 24, step_generator(args.seed, i), dev))
                losses.append(float(m["loss"]))
            out[dev] = (losses, grads,
                        [t.cpu() for t in tree_flatten(state.params)])
        (lc, gc_, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
        loss_err = max(abs(a - b) for a, b in zip(lc, lg))
        if not loss_err <= TOL["float32"]:
            raise AssertionError(f"{TR}: float32 twin {arch}: losses "
                                 f"{lg} on the card, {lc} on the CPU")
        g_err = twin_diff(arch, "grads", gc_, gg)
        p_err = twin_diff(arch, "params after 3 steps", pc, pg)
        log(f"{TR}: float32 twin {arch} ({'ragged' if ragged else 'padded'}"
            f"): card against CPU, grads within {g_err:.2e}, 3 train steps' "
            f"losses within {loss_err:.2e}, params within {p_err:.2e}")


def train_resume(args):
    """At smoke size in bf16 on the card: 4 steps straight against 2 steps,
    ``save_checkpoint``, ``restore_checkpoint`` into a fresh state and 2
    more; every param and moment must be the same bits."""
    import tempfile

    from repro_torch.bridge import tree_flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.ft import (checkpoint_step, restore_checkpoint,
                                save_checkpoint)
    from repro_torch.launch.train import make_batch, step_generator
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, make_train_state,
                                   make_train_step)
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    fns = build_model(cfg)
    ocfg = AdamWConfig(lr=1e-3)
    step = make_train_step(lambda p, b: fns.loss(p, b), ocfg)

    def fresh():
        return make_train_state(fns.init(
            torch.Generator("cuda").manual_seed(args.seed), device="cuda"),
            ocfg)

    def run(state, lo, hi):
        for i in range(lo, hi):
            state, _ = step(state, make_batch(
                cfg, 8, 32, step_generator(args.seed, i), "cuda"))
        return state

    straight = run(fresh(), 0, 4)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt")
        save_checkpoint(path, run(fresh(), 0, 2), step=2)
        start = checkpoint_step(path)
        resumed = run(restore_checkpoint(path, fresh()), start, 4)
    a, b = tree_flatten(straight), tree_flatten(resumed)
    same = sum(torch.equal(x, y) for x, y in zip(a, b))
    if same != len(a):
        raise AssertionError(f"{TR}: resume: {len(a) - same} of {len(a)} "
                             f"leaves differ from the uninterrupted run")
    log(f"{TR}: resume (smoke qwen3-moe, bf16, on the card): 4 steps "
        f"straight and 2 + save + restore + 2 give the same bits in all "
        f"{len(a)} leaves of the train state")


def train_subprocesses():
    """The CLI (a checkpoint, then a resume from it), quickstart and the
    fault-tolerance demo as a user runs them, on the card."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))

    def run(args, expect):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", *args], env=env,
                             cwd=HERE, capture_output=True, text=True,
                             timeout=600)
        if out.returncode or expect not in out.stdout:
            raise AssertionError(f"{' '.join(args)}: exit {out.returncode}"
                                 f"\n{out.stdout[-3000:]}\n"
                                 f"{out.stderr[-4000:]}")
        line = [ln for ln in out.stdout.splitlines() if expect in ln][-1]
        log(f"{TR}: python -m {' '.join(args)} on the card: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s: {line.strip()}")

    with tempfile.TemporaryDirectory() as d:
        ck = ["--checkpoint", os.path.join(d, "ck"), "--checkpoint-every",
              "2"]
        run(["repro_torch.launch.train", "--steps", "4", *ck],
            "checkpointed at step 4")
        run(["repro_torch.launch.train", "--steps", "6", "--resume", *ck],
            "resumed from step 4")
    run(["repro_torch.examples.quickstart"], "generated token ids")
    run(["repro_torch.examples.fault_tolerance_demo"],
        "bit-exact continuation: True")


def train_phase(args, counters):
    """qwen3-moe-30b-a3b at full width and ``--layers`` of its 48 layers
    trained on the card through ``build_model(cfg).loss`` and
    ``make_train_step``, on one fixed batch of 4 x 512 tokens from
    ``--seed``: 4 steps on the ragged path (bf16 params and moments, lr
    1e-3; the expert GEMMs' forward, recompute and dx on the tensor
    cores), 2 on the padded path (``moe_gmm`` for the forward, dx and dw),
    one with int8 moments and int8 gradient compression; then the float32
    twins card against CPU, the resume's bits, and the CLI, quickstart and
    the fault-tolerance demo as subprocesses. Returns the summed (launches,
    tensor-core launches) of the full-width steps."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import make_batch, step_generator
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, make_train_state,
                                   make_train_step)
    full = get_config("qwen3-moe-30b-a3b")
    cfg = reduced(full, n_layers=args.layers)
    L = cfg.n_layers
    log(f"{TR}: qwen3-moe-30b-a3b: reduced n_layers {full.n_layers}→{L} "
        f"(width unchanged; params, grads and bf16 moments take 8 bytes a "
        f"parameter: {full.param_count() * 8 / 2**30:.1f} GiB at full depth "
        f"do not fit one 80 GB card)")
    params = init_family(cfg, args.seed, "qwen3-moe-30b-a3b", TR)
    fns = build_model(cfg)
    batch = make_batch(cfg, 4, 512, step_generator(args.seed, 0), "cuda")
    ocfg = AdamWConfig(lr=1e-3)
    box = [make_train_state(params, ocfg)]
    del params
    st = box[0]
    log(f"{TR}: train state: params {tree_bytes(st.params) / 2**30:.2f} "
        f"GiB, grads {tree_bytes(st.params) / 2**30:.2f} GiB (the params'"
        f" dtypes), bf16 moments "
        f"{tree_bytes((st.opt.mu, st.opt.nu)) / 2**30:.2f} GiB; a "
        f"checkpoint of it would write {tree_bytes(st) / 2**30:.2f} GiB "
        f"(not taken at full width)")
    del st
    total, total_tc = {}, {}

    def add(launches, tc):
        for acc, c in ((total, launches), (total_tc, tc)):
            for k, v in c.items():
                acc[k] = acc.get(k, 0) + v

    # forward, its recompute in the backward and dx: 3 products each
    state, losses, launches, tc = train_steps(
        "ragged, bf16 moments", make_train_step(
            lambda p, b: fns.loss(p, b), ocfg), box, batch, 4, counters,
        {"moe_gmm_ragged": 4 * L * 9})
    check_routes(TR, launches, tc, ("moe_gmm_ragged",))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{TR}: the loss did not fall on the repeated "
                             f"batch: {losses}")
    add(launches, tc)
    # one more step under the profiler: where a step's device time goes
    box = [state]
    del state
    step_fn = make_train_step(lambda p, b: fns.loss(p, b), ocfg)

    def run():
        state, m = step_fn(box.pop(), batch)
        box.append(state)
        return f"one ragged train step (loss {float(m['loss']):.4f})"

    profiled(f"{TR} step", run)
    # the padded path from the same init: its first step must lower the
    # loss as the ragged path's did (a later step of Adam at lr 1e-3 on a
    # repeated batch may overshoot)
    box.clear()
    gc.collect()
    torch.cuda.empty_cache()
    box.append(make_train_state(
        init_family(cfg, args.seed, "qwen3-moe-30b-a3b", TR), ocfg))
    # forward, recompute, dx and dw: 3 products each
    m = cfg.moe
    C = max(-(-512 * m.top_k * m.capacity_factor // m.n_experts), 4)
    state, losses, launches, tc = train_steps(
        f"padded (C = {int(C)} a row), bf16 moments", make_train_step(
            lambda p, b: fns.loss(p, b, ragged=False), ocfg), box, batch,
        2, counters, {"moe_gmm": 2 * L * 12})
    check_routes(TR, launches, tc, ("moe_gmm",))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{TR}: the padded path's loss did not fall: "
                             f"{losses}")
    add(launches, tc)
    params = state.params
    del state
    gc.collect()
    torch.cuda.empty_cache()
    i8 = AdamWConfig(lr=1e-3, moment_dtype="int8")
    box = [make_train_state(params, i8)]
    del params
    log(f"{TR}: int8 moments: "
        f"{tree_bytes(box[0].opt) / 2**30:.2f} GiB with their scales")
    state, _, launches, tc = train_steps(
        "ragged, int8 moments, int8 gradient compression", make_train_step(
            lambda p, b: fns.loss(p, b), i8, grad_compression="int8"),
        box, batch, 1, counters, {"moe_gmm_ragged": L * 9})
    add(launches, tc)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    train_twins(args)
    train_resume(args)
    train_subprocesses()
    return total, total_tc


# ------------------------------------------------------------------ sharded
SH = "sharded"
SHARD_DIR = os.path.join(HERE, "build", "sharded")      # gitignored


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)


def _decode_steps(fns, params, cache, toks, lengths, **kw):
    """One decode step per row of ``toks`` at ``lengths``, ``lengths`` + 1,
    ...; returns [(logits, stats)] and the cache."""
    out = []
    for i, tok in enumerate(toks):
        lg, cache, st = fns.decode(params, tok, cache, lengths + i, **kw)
        out.append((lg, st))
    return out, cache


def _record_sublayers(fns, params, batch, cache, n_steps, kw):
    """The world-1 run the two ranks are held to, sublayer by sublayer:
    prefill, then ``n_steps`` greedy decode steps, recording each layer's
    attention (input, positions, output) and MoE (normed input, output, B
    and A) on the host, and the tokens fed. Returns {"attn": [[...] per
    step], "moe": ..., "toks": [...], "next": the token after the last}."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    rec = {"attn": [], "moe": [], "toks": []}
    attn0, moe0 = tfm.attention_block, moe_mod.moe_layer

    def attention(lp, cfg, desc, x, positions, cache, mode, paged=None,
                  policy=None):
        out, c = attn0(lp, cfg, desc, x, positions, cache, mode, paged,
                       policy)
        rec["attn"][-1].append((x.cpu(), positions.cpu(), out.cpu()))
        return out, c

    def moe(params, cfg, x, placement, **mkw):
        y, st = moe0(params, cfg, x, placement, **mkw)
        rec["moe"][-1].append((x.cpu(), y.cpu(),
                               st["expert_counts"].cpu(),
                               st["source_expert"].cpu()))
        return y, st

    lengths = batch["lengths"]
    tfm.attention_block, moe_mod.moe_layer = attention, moe
    try:
        for step in range(n_steps + 1):
            rec["attn"].append([])
            rec["moe"].append([])
            if step == 0:
                lg, cache, _ = fns.prefill(params, batch, cache, **kw)
            else:
                lg, cache, _ = fns.decode(params, rec["toks"][-1].to(
                    lengths.device), cache, lengths + step - 1, **kw)
            rec["toks"].append(lg.argmax(-1).to(torch.int32).cpu())
    finally:
        tfm.attention_block, moe_mod.moe_layer = attn0, moe0
    rec["next"] = rec["toks"].pop()
    return rec


def _twin_cpu(seed):
    """The float32 twin (the smoke config at 2 layers) on the CPU, world 1:
    params from ``seed``, prefill of 4 x 24 tokens into 32-slot rings, 4
    greedy decode steps; the logits, statistics and caches the two ranks
    on the card are held to."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.models import build_model
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    fns = build_model(cfg)
    params = fns.init(torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 24), generator=g,
                           dtype=torch.int32)
    lengths = torch.tensor([24, 19, 24, 21], dtype=torch.int32)
    src = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    kw = dict(source_ids=src, n_sources=2)
    lg, cache, st = fns.prefill(params, {"tokens": tokens,
                                         "lengths": lengths},
                                fns.init_cache(4, 32, device="cpu"), **kw)
    logits, stats, toks = [lg], [st], []
    for i in range(4):
        toks.append(lg.argmax(-1).to(torch.int32))
        lg, cache, st = fns.decode(params, toks[-1], cache, lengths + i, **kw)
        logits.append(lg)
        stats.append(st)
    return {"params": params, "tokens": tokens, "lengths": lengths,
            "src": src, "toks": toks, "logits": logits,
            "stats": [{k: s[k] for k in ("expert_counts", "source_expert")}
                      for s in stats],
            "cache": tree_map(torch.clone, cache)}


# the sharded phase's sizes: a decode cell of B rows over an L-slot ring,
# prefilled with P tokens and decoded STEPS steps; split-K on L2-slot rings;
# the two ranks' prefill of P3 tokens and STEPS3 decode steps
SH_B, SH_P, SH_L, SH_STEPS = 8, 1024, 32768, 16
SH_L2, SH_P3, SH_STEPS3 = 2048, 256, 8


def _sharded_cfg(layers):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config("qwen3-moe-30b-a3b"), n_layers=layers)


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them, printed
    beside every time of the sharded phase."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


@contextlib.contextmanager
def shards_held(tfm, seen):
    """While open, every split-K shard that ``transformer`` launches
    (``flash_decode(return_lse=True)``) is held to ``flash_decode_plain``
    on the same inputs, at the path's own shapes: appends (the shard's
    cache shape, max_abs_err of output and log-sum-exp, row_rel_err of the
    output) to ``seen``. These comparisons run outside the counted runs."""
    from repro_torch.kernels.decode_route import row_rel_err
    from repro_torch.kernels.flash_decode import flash_decode_plain
    kernel = tfm.flash_decode

    def held(q, k, v, k_pos, q_pos, **kw):
        out, lse = kernel(q, k, v, k_pos, q_pos, **kw)
        ref, ref_lse = flash_decode_plain(q, k, v, k_pos, q_pos, **kw)
        seen.append((tuple(k.shape), max(max_err(out, ref),
                                         lse_err(lse, ref_lse)),
                     row_rel_err(out, ref)))
        return out, lse

    tfm.flash_decode = held
    try:
        yield
    finally:
        tfm.flash_decode = kernel


def check_shards(label, seen, n_expected):
    """Fails unless ``n_expected`` shards were held and each met the bf16
    bars of the kernel rows (max_abs_err and each row's norm); one line."""
    from repro_torch.kernels.decode_route import ROW_TOL
    tol, rtol = TOL["bfloat16"], ROW_TOL[torch.bfloat16]
    err = max((e for _, e, _ in seen), default=float("nan"))
    rel = max((r for _, _, r in seen), default=float("nan"))
    shapes = sorted({s for s, _, _ in seen})
    ok = len(seen) == n_expected and err <= tol and rel <= rtol
    line = (f"{label}: {len(seen)} flash_decode shards (f32 output + "
            f"log-sum-exp, caches {shapes}) held to flash_decode_plain on "
            f"the same inputs: max_abs_err {err:.3g} (tolerance {tol:g}), "
            f"row_rel_err {rel:.3g} (tolerance {rtol:g}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{line}; expected {n_expected} shards")
    return line


def sharded_phase(args, counters):
    """The sharding policy on the card (ROADMAP Queue A item 11a).

    1. World size 1: qwen3-moe-30b-a3b at full width and ``--layers``
       layers, bf16, on a (1, 1) data x model mesh over NCCL, under
       ``make_policy(..., "serve")`` for a decode cell of B = 8 over a
       32768-slot ring (4 GiB of cache at 8 layers): prefill of 8 x 1024
       tokens and 16 decode steps with the policy and without it give the
       same bits (logits, caches, statistics).
    2. Split-K on the card: kv_split forced to 4 and to 8, on rings of
       2048 slots that the context spans (of a 32768-slot ring it fills
       only the first shard, which alone gives the unsplit bits). Each
       decode step runs from a copy of the unsplit run's cache with its
       token: ``flash_decode`` launches kv_split times a layer-step, all
       on the tensor cores; the logits meet the unsplit step's within the
       bf16 bar of each row's norm (``row_rel_err`` 3e-2: 8 layers of bf16
       carry one-unit differences into the logits, whose largest elementwise
       difference over 19 M of them is a tail, not a bar) on every row whose
       experts in every layer were the unsplit step's, at least half of them
       (the f32 merge
       rounds a few attention outputs one bf16 unit off, and the router
       then flips near-ties: ROADMAP Queue C, bf16 routing); each layer's
       attention output is held row by row to the unsplit one on the same
       query and cache (``row_rel_err`` 1e-2), each shard's f32 output and
       log-sum-exp to ``flash_decode_plain`` on the same inputs
       (:func:`shards_held`), and one layer's device time split and
       unsplit is printed.
    3. Two ranks on the one card (a (1, 2) mesh over gloo, this script
       started twice): each holds 64 of 128 experts, 16 of 32 query heads'
       columns, 2 of 4 KV heads' columns, half the vocabulary and half of
       each ring (kv_split 2 over ``model``), exactly its spec's share of
       the parameters; each layer's attention and MoE, fed the world-1
       run's inputs, meet its outputs at the bf16 bar over a prefill of 8 x
       256 tokens and 8 decode steps, with the statistics exact, and each
       decode shard (16384 slots) to ``flash_decode_plain``; each rank's
       decode step wall and its collectives' share.
    4. The float32 twin across the same two ranks on the card: logits within
       1e-5 of the CPU world-1 run, statistics exact.
    Returns the launch counts of the world-1 run under the policy."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.bridge import tree_map
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.decode_route import ROW_TOL, row_rel_err
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    os.makedirs(SHARD_DIR, exist_ok=True)
    dev = torch.device("cuda")
    cfg = _sharded_cfg(args.layers)
    ns = cfg.n_layers
    B, P, L, steps = SH_B, SH_P, SH_L, SH_STEPS
    mesh = make_device_mesh((1, 1), ("data", "model"), "cuda",
                            init_method=f"file://{SHARD_DIR}/store_w1_"
                                        f"{os.getpid()}", rank=0,
                            world_size=1)
    pol = sh.make_policy(cfg, ShapeConfig("decode_b8_32k", L, B, "decode"),
                         mesh, "serve")
    log(f"{SH}: world 1: a (1, 1) data x model mesh over {mesh.backend}, "
        f"policy batch_axes {pol.batch_axes}, kv_split {pol.kv_split} over "
        f"{pol.kv_split_axes}, expert_data_shard {pol.expert_data_shard}")
    fns = build_model(cfg)
    params = init_family(cfg, args.seed, "qwen3-moe-30b-a3b", SH)
    g = torch.Generator(device=dev).manual_seed(args.seed + 22)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device=dev, dtype=torch.int32)
    lengths = torch.full((B,), P, dtype=torch.int32, device=dev)
    src = (torch.arange(B, device=dev) % 2).to(torch.int32)
    kw = dict(source_ids=src, n_sources=2)
    batch = {"tokens": tokens, "lengths": lengths}

    # 1. the same bits with the policy and without it
    t0 = time.perf_counter()
    lg, cache, st = fns.prefill(params, batch,
                                fns.init_cache(B, L, device=dev), **kw)
    plain, toks = [(lg, st)], []
    for i in range(steps):
        toks.append(lg.argmax(-1).to(torch.int32))
        lg, cache, st = fns.decode(params, toks[i], cache, lengths + i, **kw)
        plain.append((lg, st))
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    reset_counts(counters)
    t0 = time.perf_counter()
    lg, cache_p, st = fns.prefill(params, batch,
                                  fns.init_cache(B, L, device=dev),
                                  policy=pol, **kw)
    under = [(lg, st)]
    outs, cache_p = _decode_steps(fns, params, cache_p, toks, lengths,
                                  policy=pol, **kw)
    under += outs
    torch.cuda.synchronize()
    t_under = time.perf_counter() - t0
    w1_launches, w1_tc = read_counts(counters)
    same = all(torch.equal(a[0], b[0]) and _tree_equal(a[1], b[1])
               for a, b in zip(plain, under)) and _tree_equal(cache, cache_p)
    if not same:
        raise AssertionError(f"{SH}: world 1: the policy changed bits")
    log(f"{SH}: world 1: prefill of {B} x {P} tokens + {steps} decode steps "
        f"with the policy: logits, caches and statistics the same bits as "
        f"without it ({t_under:.2f} s wall; {t_plain:.2f} s without; "
        f"{_card()}); "
        f"launches { {k: v for k, v in w1_launches.items() if v} }")
    del cache, cache_p, plain, under
    # 2. split-K, kv_split forced to 4 and 8, on a ring of L2 slots that
    #    the context spans (the 1024 + 16 tokens fill only the first shard
    #    of a 32768-slot ring, and one shard alone gives the unsplit bits).
    #    Each step runs from a copy of the unsplit run's cache with its
    #    token: launches and logits a step.
    L2 = SH_L2
    from repro_torch.models import moe as moe_mod
    route0, routes = moe_mod.route, []

    def route(params, cfg, x):       # each layer's experts, per row
        gates, ids, probs = route0(params, cfg, x)
        routes.append(ids.reshape(-1, ids.shape[-1]).sort(dim=-1).values)
        return gates, ids, probs

    def taken():
        out = torch.stack(routes)
        routes.clear()
        return out                   # (layers, B, K)

    lg, cache, _ = fns.prefill(params, batch,
                               fns.init_cache(B, L2, device=dev), **kw)
    plain, split_rows, split_counts = [], {4: [], 8: []}, {4: [], 8: []}
    moe_mod.route = route
    try:
        for i in range(steps):
            before = tree_map(torch.clone, cache)
            routes.clear()
            lg, cache, _ = fns.decode(params, toks[i], cache, lengths + i,
                                      **kw)
            plain.append((lg, taken()))
            for kv in (4, 8):
                c = tree_map(torch.clone, before) if kv == 4 else before
                reset_counts(counters)
                lk, _, _ = fns.decode(params, toks[i], c, lengths + i,
                                      policy=dataclasses.replace(
                                          pol, kv_split=kv, cache_len=L2),
                                      **kw)
                launches, tc = read_counts(counters)
                split_counts[kv].append((launches["flash_decode"],
                                         tc["flash_decode"]))
                split_rows[kv].append((lk, taken()))
                del c
            del before
    finally:
        moe_mod.route = route0
    for kv in (4, 8):
        counts = split_counts[kv]
        if any(n != kv * ns or t != kv * ns for n, t in counts):
            raise AssertionError(f"{SH}: kv_split {kv}: flash_decode "
                                 f"launches (all, tensor cores) a step "
                                 f"{counts}, expected {kv * ns} each")
        held, rel, worst, worst_abs = 0, 0.0, 0.0, 0.0
        for (la, ra), (lk, rk) in zip(plain, split_rows[kv]):
            same = (ra == rk).all(dim=2).all(dim=0)       # (B,)
            held += int(same.sum())
            if same.any():
                rel = max(rel, row_rel_err(lk[same], la[same]))
                worst = max(worst, bar_err(lk[same], la[same]))
                worst_abs = max(worst_abs, max_err(lk[same], la[same]))
        rows = steps * B
        if rel > TOL["bfloat16"] or held < rows // 2:
            raise AssertionError(f"{SH}: kv_split {kv}: logits row_rel_err "
                                 f"{rel} over {held} of {rows} rows routed "
                                 f"as in the unsplit step")
        log(f"{SH}: split-K {kv} on {L2}-slot rings ({L2 // kv} slots a "
            f"shard, the context {P} to {P + steps} tokens): {steps} decode "
            f"steps, flash_decode {counts[0][0]} launches a step ({kv} a "
            f"layer), {counts[0][1]} on the tensor cores; logits against the "
            f"unsplit step: row_rel_err at most {rel:.3g} (bar "
            f"{TOL['bfloat16']:g} of each row's norm; elementwise "
            f"max_abs_err {worst_abs:.3g}, |a - b| / (1 + |b|) {worst:.3g}) "
            f"over the {held} of {rows} rows whose experts in every layer "
            f"were the unsplit step's; the other {rows - held} took another "
            f"expert on a near-tie somewhere (bf16 routing, ROADMAP Queue C)")
    del split_rows, plain
    # each layer's attention output, split against unsplit on the same q
    # and cache, and one layer's device time
    timer = Timer(iters=10, warmup=2)
    orig = tfm.split_decode
    for kv in (4, 8):
        rels, times, seen = [], {}, []

        def held(q, ck, cv, positions, k_pos, window, cap, n_split,
                 k_scale=None, v_scale=None, policy=None):
            with shards_held(tfm, seen):
                out = orig(q, ck, cv, positions, k_pos, window, cap,
                           n_split, k_scale, v_scale, policy)
            whole = orig(q, ck, cv, positions, k_pos, window, cap, 1,
                         k_scale, v_scale)
            rels.append(row_rel_err(out, whole))
            if not times:
                for name, n in (("split", n_split), ("unsplit", 1)):
                    times[name] = timer.device(lambda n=n: orig(
                        q, ck, cv, positions, k_pos, window, cap, n,
                        k_scale, v_scale))[0]
            return out

        tfm.split_decode = held
        try:
            c = tree_map(torch.clone, cache)
            fns.decode(params, lg.argmax(-1).to(torch.int32), c,
                       lengths + steps, policy=dataclasses.replace(
                           pol, kv_split=kv, cache_len=L2), **kw)
            del c
        finally:
            tfm.split_decode = orig
        if len(rels) != ns or max(rels) > ROW_TOL[torch.bfloat16]:
            raise AssertionError(f"{SH}: split-K {kv}: attention rows "
                                 f"{rels} (tolerance "
                                 f"{ROW_TOL[torch.bfloat16]})")
        log(f"{SH}: split-K {kv}: each of {ns} layers' attention output "
            f"against the unsplit decode on the same q and cache: "
            f"row_rel_err at most {max(rels):.3g} (tolerance "
            f"{ROW_TOL[torch.bfloat16]:g}); one layer's decode attention, "
            f"device time (torch.profiler): split {times['split']:.4f} ms, "
            f"unsplit {times['unsplit']:.4f} ms ({_card()})")
        log(f"{SH}: " + check_shards(f"split-K {kv} on {L2}-slot rings",
                                     seen, kv * ns))
    del cache
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the world-1 run the two ranks are held to, sublayer by sublayer
    t3 = torch.randint(0, cfg.vocab_size, (B, SH_P3), generator=g,
                       device=dev, dtype=torch.int32)
    l3 = torch.full((B,), SH_P3, dtype=torch.int32, device=dev)
    rec = _record_sublayers(fns, params, {"tokens": t3, "lengths": l3},
                            fns.init_cache(B, L, device=dev), SH_STEPS3, kw)
    rec.update(tokens=t3.cpu(), lengths=l3.cpu(), src=src.cpu())
    del params, fns
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    torch.save(rec, os.path.join(SHARD_DIR, "record.pt"))
    torch.save(_twin_cpu(args.seed), os.path.join(SHARD_DIR, "twin.pt"))
    del rec
    job = {"src": os.path.join(HERE, "src"), "seed": args.seed,
           "layers": args.layers,
           "store": os.path.join(SHARD_DIR, f"store_w2_{os.getpid()}"),
           "record": os.path.join(SHARD_DIR, "record.pt"),
           "twin": os.path.join(SHARD_DIR, "twin.pt"),
           "out": os.path.join(SHARD_DIR, "rank")}
    path = os.path.join(SHARD_DIR, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sharded-rank", str(r), "--sharded-job",
                               path], env=env, cwd=HERE,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0] + "\n(killed at the timeout)")
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            if "USDT" not in line and "Warning" not in line:
                log(f"{SH}: rank {r}: {line}")
        if p.returncode:
            raise AssertionError(f"{SH}: rank {r} exited {p.returncode}")
    log(f"{SH}: two ranks on one card: both exited 0 in "
        f"{time.perf_counter() - t0:.1f} s ({_card()})")
    return w1_launches, w1_tc


def sharded_rank(args) -> int:
    """One rank of the sharded phase's (1, 2) world on the one card: steps
    3 and 4 of ``sharded_phase``. Prints its lines; exits non-zero on a
    failed check."""
    import torch.distributed as dist
    with open(args.sharded_job) as f:
        job = json.load(f)
    sys.path.insert(0, job["src"])
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api, build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import moe_layer
    rank = args.sharded_rank
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_device_mesh((1, 2), ("data", "model"), "cuda",
                            init_method=f"file://{job['store']}", rank=rank,
                            world_size=2)
    dev = mesh.device
    cfg = _sharded_cfg(job["layers"])
    B, L = SH_B, SH_L
    pol = sh.make_policy(cfg, ShapeConfig("decode_b8_32k", L, B, "decode"),
                         mesh, "serve")
    if (pol.kv_split, pol.kv_split_axes) != (2, ("model",)):
        raise AssertionError(f"policy {pol}")
    fns = build_model(cfg)
    full = fns.init(torch.Generator(device=dev).manual_seed(job["seed"]),
                    device=dev)
    specs = sh.make_param_specs(full, cfg, pol)
    params = sh.shard_params(full, specs, pol)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    abstract = api.param_specs_abstract(cfg)
    want = sh.spec_bytes(abstract, sh.make_param_specs(abstract, cfg, pol),
                         pol)
    have = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    blk = params["blocks"]["pos0"]
    print(f"mesh {mesh}, backend {mesh.backend}, {dev}: experts "
          f"{blk['moe']['w_gate'].shape[1]} of {cfg.moe.n_experts}, query "
          f"heads {blk['attn']['wq'].shape[-1] // cfg.head_dim} of "
          f"{cfg.n_heads}, KV head columns {blk['attn']['wk'].shape[-1]} of "
          f"{cfg.kv_dim} ({blk['attn']['wk'].shape[-1] // cfg.head_dim} of "
          f"{cfg.n_kv_heads} heads), vocabulary rows "
          f"{params['embed']['embedding'].shape[0]} of {cfg.vocab_size}; "
          f"resident params {have / 2**30:.4f} GiB = its spec share "
          f"{want / 2**30:.4f} GiB: {have == want}", flush=True)
    if have != want:
        raise AssertionError(f"resident {have} bytes, spec share {want}")
    abs_cache = fns.init_cache(B, L, device="meta")
    cspecs = sh.cache_specs_tree(cfg, pol, abs_cache)
    cache = sh.local_zeros(abs_cache, cspecs, pol, dev)
    print(f"cache shard {tuple(cache['pos0']['k'].shape)} of "
          f"{tuple(abs_cache['pos0']['k'].shape)} per leaf", flush=True)
    rec = torch.load(job["record"])
    src = rec["src"].to(dev)
    desc = tfm.period_descriptors(cfg)[0]
    place = torch.arange(cfg.moe.n_experts, dtype=torch.int32, device=dev)
    views = tfm._sharded_block_views(params["blocks"], cfg.n_layers // len(
        tfm.period_descriptors(cfg)), pol)
    worst = {"attention": 0.0, "moe": 0.0}
    bar = {"attention": 0.0, "moe": 0.0}
    seen = []                    # the decode steps' split-K shards
    for step, (attn, moe) in enumerate(zip(rec["attn"], rec["moe"])):
        mode = "prefill" if step == 0 else "decode"
        for i, ((x, pos, out_ref), (xn, y_ref, b_ref, a_ref)) in \
                enumerate(zip(attn, moe)):
            lp = views(i)["pos0"]
            c = {k: v[i] for k, v in cache["pos0"].items()}
            with shards_held(tfm, seen):
                out, _ = tfm.attention_block(lp, cfg, desc, x.to(dev),
                                             pos.to(dev), c, mode, None, pol)
            worst["attention"] = max(worst["attention"],
                                     max_err(out.cpu(), out_ref))
            bar["attention"] = max(bar["attention"],
                                   bar_err(out.cpu(), out_ref))
            Bx, S = xn.shape[:2]
            y, st = moe_layer(lp["moe"], cfg, xn.to(dev), place,
                              source_ids=src, n_sources=2, policy=pol)
            worst["moe"] = max(worst["moe"], max_err(y.cpu(), y_ref))
            bar["moe"] = max(bar["moe"], bar_err(y.cpu(), y_ref))
            if not (torch.equal(st["expert_counts"].cpu(), b_ref)
                    and torch.equal(st["source_expert"].cpu(), a_ref)):
                raise AssertionError(f"step {step} layer {i}: statistics "
                                     f"differ from the world-1 run")
    n_steps = len(rec["attn"])
    ok = max(bar.values()) <= TOL["bfloat16"]
    print(f"per layer against the world-1 run (prefill of "
          f"{rec['tokens'].shape[0]} x {rec['tokens'].shape[1]} tokens, "
          f"{n_steps - 1} decode steps, {cfg.n_layers} layers): attention "
          f"max_abs_err {worst['attention']:.3g}, MoE max_abs_err "
          f"{worst['moe']:.3g}; |a - b| / (1 + |b|) at most "
          f"{bar['attention']:.3g} and {bar['moe']:.3g} (bar "
          f"{TOL['bfloat16']:g}, as allclose's rtol = atol) "
          f"{'ok' if ok else 'FAIL'}; B/A statistics exact", flush=True)
    if not ok:
        raise AssertionError(f"per-layer errors {worst}, {bar}")
    print(check_shards("decode attention", seen,
                       (n_steps - 1) * cfg.n_layers), flush=True)
    # a decode step through the entry point: its wall and the collectives'
    # share (record_function ranges of distributed/sharding.py)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lengths = rec["lengths"].to(dev) + n_steps - 1
    tok = rec["next"].to(dev)
    kw = dict(source_ids=src, n_sources=2, policy=pol)
    walls = []
    for i in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, _ = fns.decode(params, tok, cache, lengths + i, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, _ = fns.decode(params, tok, cache, lengths + 3, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # each record_function range also shows as a GPU user annotation:
    # count and time the host-side ranges only
    host = [e for e in prof.events() if e.name.startswith("collective:")
            and e.device_type == DeviceType.CPU]
    coll = sum(e.cpu_time_total for e in host) / 1e6
    n_coll = len(host)
    print(f"decode step of {B} rows through the entry point ({_card()}): "
          f"{[round(w * 1e3, 2) for w in walls]} ms wall, profiled "
          f"{wall * 1e3:.2f} ms, of it {coll * 1e3:.2f} ms "
          f"({100 * coll / wall:.1f}%) in {n_coll} collectives (gloo, "
          f"through the host); logits {tuple(lg.shape)} finite "
          f"{bool(torch.isfinite(lg).all())}", flush=True)
    del params, cache, rec
    gc.collect()
    torch.cuda.empty_cache()
    # 4. the float32 twin across the two ranks, against the CPU world 1
    scfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                   dtype="float32")
    twin = torch.load(job["twin"])
    spol = sh.make_policy(scfg, ShapeConfig("twin", 32, 4, "decode"), mesh,
                          "serve")
    sp = sh.shard_params(twin["params"], sh.make_param_specs(
        twin["params"], scfg, spol), spol, device=dev)
    sfns = build_model(scfg)
    sabs = sfns.init_cache(4, 32, device="meta")
    scache = sh.local_zeros(sabs, sh.cache_specs_tree(scfg, spol, sabs),
                            spol, dev)
    skw = dict(source_ids=twin["src"].to(dev), n_sources=2, policy=spol)
    lg, scache, st = sfns.prefill(sp, {"tokens": twin["tokens"].to(dev),
                                       "lengths": twin["lengths"].to(dev)},
                                  scache, **skw)
    errs, exact = [max_err(lg.cpu(), twin["logits"][0])], [
        all(torch.equal(st[k].cpu(), twin["stats"][0][k])
            for k in twin["stats"][0])]
    for i, tk in enumerate(twin["toks"]):
        lg, scache, st = sfns.decode(sp, tk.to(dev), scache,
                                     twin["lengths"].to(dev) + i, **skw)
        errs.append(max_err(lg.cpu(), twin["logits"][i + 1]))
        exact.append(all(torch.equal(st[k].cpu(), twin["stats"][i + 1][k])
                         for k in twin["stats"][i + 1]))
    ok = max(errs) <= 1e-5 and all(exact)
    print(f"float32 twin (smoke config, 2 layers, kv_split "
          f"{spol.kv_split} over {spol.kv_split_axes}) on the card against "
          f"the CPU world-1 run: prefill + {len(twin['toks'])} decode steps, "
          f"logits max_abs_err {max(errs):.3g} (bar 1e-05), B/A statistics "
          f"exact: {all(exact)} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"float32 twin: errors {errs}, exact {exact}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main() -> int:
    args = parse_args()
    if args.sharded_rank is not None:    # started by sharded_phase
        return sharded_rank(args)
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
    del params                    # qwen3's weights: room for llama4's
    gc.collect()
    torch.cuda.empty_cache()
    l4_launches, l4_tc = llama4_serve_phase(args, counters)
    phase_done("llama4_serve (profiled)")
    gc.collect()
    torch.cuda.empty_cache()
    df_launches, df_tc = dense_families_phase(args, counters)
    phase_done("dense_families")
    gc.collect()
    torch.cuda.empty_cache()
    of_launches, of_tc = other_families_phase(args, counters)
    phase_done("other_families")
    gc.collect()
    torch.cuda.empty_cache()
    tr_launches, tr_tc = train_phase(args, counters)
    phase_done("train")
    gc.collect()
    torch.cuda.empty_cache()
    sh_launches, sh_tc = sharded_phase(args, counters)
    phase_done("sharded")
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
                       "scenario_serve": scen_tc.get(name, 0),
                       "llama4_serve": l4_tc.get(name, 0),
                       "dense_families": df_tc.get(name, 0),
                       "other_families": of_tc.get(name, 0),
                       "train": tr_tc.get(name, 0),
                       "sharded": sh_tc.get(name, 0)}}
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": main_launches[name],
            "launches_by_path": {"serve": serve_launches.get(name, 0),
                                 "cluster_serve": launches.get(name, 0),
                                 "dense_cluster_serve": dense_launches[name],
                                 "scenario_serve": scen_launches.get(name, 0),
                                 "llama4_serve": l4_launches.get(name, 0),
                                 "dense_families": df_launches.get(name, 0),
                                 "other_families": of_launches.get(name, 0),
                                 "train": tr_launches.get(name, 0),
                                 "sharded": sh_launches.get(name, 0)},
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
