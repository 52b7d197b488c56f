"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--layers 8] [--seed 0]

1. builds the CUDA kernels of ``src/repro_torch/csrc`` with nvcc;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and times both (CUDA events, L2
   flushed before every launch), and the one PyTorch call that computes the
   same function where there is one;
3. checks the port end to end on a small input: a float32 twin of the
   model served on the card through the kernels and on the CPU through the
   plain versions must give the same token streams and statistics, on one
   engine pair, and through ``serve_real_cluster`` on int8 KV pages with
   experts migrating, without and with a crash of engine 1;
4. serves 8 requests on two ``PagedRealEngine``s that share one runner, at
   the full width of Qwen3-30B-A3B (depth cut to ``--layers``), with random
   weights from ``--seed``, and checks what comes out: every request
   finished, tokens in the vocabulary, each kernel launched, and the MoE
   statistics B and A consistent with the tokens routed;
5. serves the same requests again under ``torch.profiler`` and prints the
   device's busy share and the kernels that take the device time;
6. serves 16 requests arriving over time through ``serve_real_cluster``
   (the Gimbal control plane: Algorithm-1 dispatch, profiler, placement,
   expert migration) on two engines with int8 KV pages at the same width,
   and checks that every request finished, both engines served, experts
   migrated on the card, and all five kernels launched;
7. prints a ``kernels`` JSON line, then as its last line
   ``{"ok": true, "device": {...}}``.

The kernel launch counters are set to 0 just before each serve of steps 4
and 6 and read just after; each serve fails if a kernel of its path was
not launched.

Any failure raises, and the script exits non-zero. It never runs on the
CPU: without a CUDA device it exits with an error before doing anything.
"""
from __future__ import annotations

import argparse
import json
import os
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
    """Mean CUDA-event time of ``fn`` with L2 flushed before each launch."""

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


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------------ kernels
def check_paged_decode(timer, dtype, int8_pages=False):
    from repro_torch.kernels.kv_pack import pack_kv_plain
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, Hq, Hkv, hd, ps, NB = 8, 32, 4, 128, 16, 64
    ctx = [0, 1, 17, 256, 511, 700, 1000, 1024]      # lane 0 empty
    P = B * NB + 1
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
    out = paged_decode(q, kp, vp, bt, ctx_t, **scales)
    ref = paged_decode_plain(q, kp, vp, bt, ctx_t, *scales.values())
    torch.cuda.synchronize()
    err = max_err(out, ref)
    if not torch.isfinite(out).all() or out[0].abs().max() != 0:
        raise AssertionError("paged_decode: non-finite output or a ctx=0 "
                             "lane that is not exactly zero")
    item = q.element_size()
    live = sum(ctx)
    # K and V of the live tokens (and their scales on int8 pages)
    row_bytes = hd * kp.element_size() + (4 if int8_pages else 0)
    nbytes = 2 * q.numel() * item + live * Hkv * 2 * row_bytes \
        + bt.numel() * 4 + B * 4
    ops = 4.0 * live * Hq * hd
    pages = "int8 pages + f32 scales" if int8_pages else "pages in q's type"
    return {"shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} ps={ps} ctx={ctx}, "
                     f"{pages}",
            "err": err,
            "ms": timer(lambda: paged_decode(q, kp, vp, bt, ctx_t,
                                             **scales)),
            "plain_ms": timer(lambda: paged_decode_plain(
                q, kp, vp, bt, ctx_t, *scales.values())),
            "bound": bound_ms(nbytes, ops, str(dtype).split(".")[1]),
            "library_ms": None}


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
    out = moe_gmm_ragged(*args, n_block=nb)
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
    lib = None
    if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        offs = disp.padded_offsets[1:].contiguous()
        # bf16 out: the library rounds its output to the input type
        lib = timer(lambda: torch._grouped_mm(disp.xs, w, offs=offs))
    return {"shape": f"{which}: T={T} K={K} E={E} D={D} F={F} nb={nb} "
                     f"Np={Np} rows={rows} experts_hit={hit}",
            "err": err,
            "ms": timer(lambda: moe_gmm_ragged(*args, n_block=nb)),
            "plain_ms": timer(lambda: moe_gmm_ragged_plain(*args,
                                                           n_block=nb)),
            "bound": bound_ms(nbytes, ops, str(dtype).split(".")[1]),
            "library_ms": lib}


def check_stats(timer, T, K):
    from repro_torch.kernels.source_expert_count import (
        source_expert_count, source_expert_count_plain)
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
    return {"shape": f"T={T} K={K} E={E} S={S} (ids include -1)",
            "err": 0.0,
            "ms": timer(lambda: source_expert_count(ids, src, **kw)),
            "plain_ms": timer(lambda: source_expert_count_plain(ids, src,
                                                                **kw)),
            "bound": bound_ms(nbytes, 2.0 * ids.numel(), "int32"),
            "library_ms": timer(lambda: torch.bincount(
                keys, minlength=(S + 1) * E)) if lib_ok else None}


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
    return {"shape": f"{which}: {tuple(shape)} (tokens, heads, hd)",
            "err": 0.0,
            "ms": timer(lambda: pack_kv(x)),
            "plain_ms": timer(lambda: pack_kv_plain(x)),
            "bound": bound_ms(nbytes, 4.0 * rows * hd, "float32"),
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
    return {"shape": f"prefill gather: {tuple(shape)} (B, L, Hkv, hd)",
            "err": 0.0,
            "ms": timer(lambda: unpack_kv(q, s, dtype)),
            "plain_ms": timer(lambda: unpack_kv_plain(q, s, dtype)),
            "bound": bound_ms(nbytes, 2.0 * n, "float32"),
            "library_ms": timer(lambda: torch.mul(q, s[..., None], out=buf))
            if lib_ok else None}


def kernel_phase():
    """Each kernel against its plain version at the serving shapes."""
    timer = Timer()
    results = {"paged_decode": [], "moe_gmm_ragged": [],
               "source_expert_count": [], "pack_kv": [], "unpack_kv": []}

    def record(kname, dt, r):
        tol = TOL.get(dt.split("/")[0], 0.0)
        ok = r["err"] <= tol
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"kernel {kname} [{dt}] {r['shape']}: max_abs_err "
            f"{r['err']:.3g} (tolerance {tol:g}) {'ok' if ok else 'FAIL'}; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), library {lib}")
        if not ok:
            raise AssertionError(f"{kname} [{dt}] disagrees with its plain "
                                 f"version: {r['err']} > {tol}")
        results[kname].append((dt, r))

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        record("paged_decode", dt, check_paged_decode(timer, dtype))
        record("paged_decode", dt + "/int8",
               check_paged_decode(timer, dtype, int8_pages=True))
        for shape, which in (((8, 1, 4, 128), "decode"),
                             ((512, 4, 128), "prefill")):
            record("pack_kv", dt, check_pack(timer, dtype, shape, which))
        record("unpack_kv", dt, check_unpack(timer, dtype, (8, 1024, 4, 128)))
        for T, which in ((8, "decode"), (256, "prefill")):
            for D, F, proj in ((2048, 768, "gate/up"), (768, 2048, "down")):
                record("moe_gmm_ragged", dt,
                       check_gmm(timer, dtype, T, D, F,
                                 f"{which} {proj}"))
    for T, K in ((2048, 1), (256, 8)):
        record("source_expert_count", "int32",
               check_stats(timer, T, K))
    return results


# ------------------------------------------------------------------ serving
def make_requests(cfg, n, lo, hi, max_new, seed, gap=0.001):
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(lo, hi + 1))
        reqs.append(Request(req_id=i, prompt_len=plen,
                            max_new_tokens=max_new, arrival_time=gap * i,
                            prompt_tokens=rng.integers(
                                0, cfg.vocab_size, plen).tolist()))
    return reqs


def serve(cfg, params, ecfg, reqs):
    """Two engines on one runner; requests alternate between them. Returns
    (engines, per-step seconds, wall seconds, (B, A) per engine)."""
    from repro_torch.serving import (PagedModelRunner, PagedRealEngine)
    runner = PagedModelRunner(cfg, params, ecfg, n_sources=2)
    engines = [PagedRealEngine(i, cfg, params, ecfg, runner=runner)
               for i in range(2)]
    for i, r in enumerate(reqs):
        engines[i % 2].enqueue(r, 0.0)
    cuda = ecfg.device == "cuda"
    steps, now = [], 0.0
    t_all = time.perf_counter()
    while any(e.has_work for e in engines):
        for e in engines:
            if not e.has_work:
                continue
            t0 = time.perf_counter()
            e.step(now)
            if cuda:
                torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        now += 0.01
        if len(steps) > 10000:
            raise AssertionError("serving did not finish in 10000 steps")
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
    for mixed in (False, True):
        out = {}
        for dev, p in (("cpu", params), ("cuda", params_gpu)):
            ecfg = PagedEngineConfig(page_size=8, n_pages=64,
                                     max_blocks_per_req=8, max_batch=4,
                                     token_budget=16, chunk_buckets=(8, 16),
                                     mixed_steps=mixed, device=dev)
            reqs = make_requests(cfg, 6, 3, 40, 6, seed=11)
            engines, _, _, stats = serve(cfg, p, ecfg, reqs)
            out[dev] = ([r.output_tokens for r in reqs], stats)
        toks_c, st_c = out["cpu"]
        toks_g, st_g = out["cuda"]
        same_stats = all(np.array_equal(a, b) for sc, sg in zip(st_c, st_g)
                         for a, b in zip(sc, sg))
        if toks_c != toks_g or not same_stats:
            raise AssertionError(f"float32 twin (mixed_steps={mixed}): card "
                                 "and CPU disagree")
        log(f"reference: float32 twin, mixed_steps={mixed}: card kernels and "
            f"CPU plain versions give the same {sum(map(len, toks_c))} "
            "tokens and B/A statistics")
    cluster_reference(cfg, params, params_gpu)


def profile_phase(cfg, params, ecfg, seed):
    """The same 8 requests again under torch.profiler: the device's busy
    share of the wall time, and the kernels that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = make_requests(cfg, 8, 100, 900, 32, seed=seed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, steps, wall, _ = serve(cfg, params, ecfg, reqs)
    # device-side events only: a host op's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        raise AssertionError("profile: the profiler recorded no device "
                             "events")
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile: {len(steps)} engine steps in {wall * 1e3:.1f} ms wall "
        f"(profiled), device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / (wall * 1e3):.1f}% of the wall time")
    for us, n, key in sorted(rows, reverse=True)[:12]:
        log(f"profile:   {us / 1e3:9.2f} ms  {n:6d} calls  {key[:90]}")


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

    for fn in counters.values():
        fn.launches = 0
    engines, steps, wall, stats = serve(cfg, params, ecfg, reqs)
    launches = {name: fn.launches for name, fn in counters.items()}

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
        f"sources = B on both engines; launches {launches}")

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
    profile_phase(cfg, params, ecfg, args.seed)
    return launches, cfg, params


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
    migrate = tfm.migrate_params_for_placement

    def timed_migrate(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = migrate(*a, **kw)
        torch.cuda.synchronize()
        moves.append(time.perf_counter() - t0)
        return out

    tfm.migrate_params_for_placement = timed_migrate
    for fn in counters.values():
        fn.launches = 0
    try:
        res, engines, wall = serve_cluster(
            cfg, params, ecfg, reqs, window_tokens=1024,
            placement_cfg=PlacementConfig.uncalibrated())
    finally:
        tfm.migrate_params_for_placement = migrate
    launches = {name: fn.launches for name, fn in counters.items()}

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
        f"{cfg.n_layers} layers); launches {launches}")
    return launches


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import ops
    from repro_torch.kernels.kv_pack import pack_kv, unpack_kv
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged
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
    log(f"build: {len(ops.KERNELS)} kernels with nvcc in {t_build:.1f} s")
    for name, text in ops.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    results = kernel_phase()
    reference_phase()
    counters = {"paged_decode": paged_decode,
                "moe_gmm_ragged": moe_gmm_ragged,
                "source_expert_count": source_expert_count}
    serve_launches, cfg, params = serve_phase(args, counters)
    counters.update(pack_kv=pack_kv, unpack_kv=unpack_kv)
    launches = cluster_phase(args, cfg, params, counters)

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
    }
    kernels = []
    for name, rows in results.items():
        main_row = rows[0][1]          # bf16 at the first serving shape
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "launches_by_path": {"serve": serve_launches.get(name, 0),
                                 "cluster_serve": launches[name]},
            "max_abs_err": max(r["err"] for dt, r in rows
                               if dt.split("/")[0] in ("bfloat16", "int32")),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound"][0],
            "bound_by": main_row["bound"][1],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"],
            "shapes": [{"dtype": dt, "shape": r["shape"], "err": r["err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"]} for dt, r in rows],
        })
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
