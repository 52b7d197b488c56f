"""The plain reference: a float32 forward over the sampled sequences, and
the gaps that decide ``correct``.

Plain PyTorch. The architecture's adapter (``arch/<name>_ref.py``) gives
the model in pieces (its embedding, one layer, its head), built from the
blocks below; :func:`served_gaps` drives them and reads the gaps, the same
for every architecture. No cache, no batching across sequences in
attention, no kernels: each sequence attends over itself in full. It
imports nothing of the program and takes nothing the program made: each
layer's weights are drawn again from the seed (``weights.py``) and widened
to float32. TF32 is off.

It runs after the window, layer by layer over every sampled sequence, so
that one layer's weights are held at a time.

``fp8=True`` gives the control: the same forward with every projection
inside the layers computed on float8 e4m3 operands, the activation scaled
per token and the weight per output column, as an fp8 serving path would
(:func:`lin`); the adapters keep the router, embedding and LM head in
float32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

from servebench import weights as W

FP8_MAX = 448.0


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with a scale per slice along
    ``dim`` (its absolute maximum maps to 448), returned in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def lin(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``x @ w``; with ``fp8``, on float8 operands (the control)."""
    if fp8:
        return _q8(x, -1) @ _q8(w, -2)
    return x @ w


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, H, hd) at positions 0 .. n-1, split halves rotated; angles in
    float64."""
    n, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None]
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, q_chunk: int = 1024):
    """q, k (H, n, dk), v (H, n, dv) -> (H, n, dv): causal softmax
    attention, ``q_chunk`` queries at a time."""
    n = q.shape[1]
    out = q.new_empty(q.shape[:-1] + v.shape[-1:])
    for a in range(0, n, q_chunk):
        b = min(n, a + q_chunk)
        s = q[:, a:b] @ k[:, :b].transpose(1, 2) * scale
        mask = torch.arange(b, device=q.device)[None] \
            > torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, :b]
    return out


def swiglu(x, gate, up, down, fp8: bool):
    """The SwiGLU FFN: ``down(silu(gate(x)) * up(x))``."""
    h = F.silu(lin(x, gate, fp8)) * lin(x, up, fp8)
    return lin(h, down, fp8)


def routed_experts(x, idx, weights, gate, up, down, fp8: bool):
    """The routed experts' sum: token t's k-th expert ``idx[t, k]`` (a
    SwiGLU FFN of the stacks ``gate``, ``up``, ``down``), weighted by
    ``weights[t, k]``."""
    out = torch.zeros_like(x)
    for e in range(gate.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out.index_add_(0, tok, swiglu(x[tok], gate[e], up[e], down[e], fp8)
                       * weights[tok, slot][:, None])
    return out


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@torch.no_grad()
def served_gaps(ref, cfg: dict, seed: int, seqs: List[dict], device,
                control: bool = False) -> Dict[str, list]:
    """The forward of the adapter ``ref`` (``arch/<name>_ref.py``) over
    each sequence ``{"prompt": ids, "output": ids}``: at every position
    that produced a served token, the reference's best logit less its
    logit of the served token (``"served"``). With ``control``, also the
    float32 reference's best logit less its logit of the token that the
    fp8 forward puts first at the same position (``"control"``). One list
    entry of gaps per sequence. For a model whose layers route, also
    ``"routing"`` (and with ``control`` ``"routing_control"``): for each
    sequence the experts each routing layer chose at each prompt position,
    an int64 tensor (routing layers, prompt length, top k) on the CPU."""
    with _no_tf32():
        streams = {"f32": False, "fp8": True} if control else {"f32": False}
        toks = [torch.as_tensor(list(s["prompt"]) + list(s["output"][:-1]),
                                dtype=torch.long, device=device)
                for s in seqs]
        lens = [t.numel() for t in toks]
        first = ref.embed(cfg, seed, toks, device)
        hs = {k: list(first) for k in streams}
        del first
        # per stream, per routing layer: the prompt positions' experts
        routed: Dict[str, List[List[torch.Tensor]]] = {k: [] for k in streams}
        for layer in range(cfg["num_hidden_layers"]):
            lp = {name: W.draw(seed, name, layer, spec, device).float()
                  for name, spec in ref.leaves(cfg, layer).items()}
            for k, fp8 in streams.items():
                hs[k], idx = ref.layer(cfg, lp, hs[k], fp8)
                if idx is not None:
                    routed[k].append([
                        t[:len(s["prompt"])].cpu() for t, s in
                        zip(idx.split(lens), seqs)])
            del lp
        logits_of = ref.head(cfg, seed, device)
        out: Dict[str, list] = {"served": []}
        if control:
            out["control"] = []
        for k, name in (("f32", "routing"), ("fp8", "routing_control")):
            if routed.get(k):
                out[name] = [torch.stack([per[i] for per in routed[k]])
                             for i in range(len(seqs))]
        for i, s in enumerate(seqs):
            p = len(s["prompt"])
            rows = slice(p - 1, p - 1 + len(s["output"]))
            logits = logits_of(hs["f32"][i][rows])
            best = logits.amax(-1)
            served = torch.as_tensor(list(s["output"]), dtype=torch.long,
                                     device=device)
            out["served"].append(
                (best - logits.gather(-1, served[:, None])[:, 0]).cpu())
            if control:
                pick = logits_of(hs["fp8"][i][rows]).argmax(-1)
                out["control"].append(
                    (best - logits.gather(-1, pick[:, None])[:, 0]).cpu())
        return out
