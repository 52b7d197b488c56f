"""The plain reference: a float32 forward of a Qwen3 configuration.

Plain PyTorch, following the published Qwen3 decoder (RMSNorm before
attention and before the FFN, q/k RMSNorm per head before rotary
embeddings that rotate split halves, grouped-query causal attention, a
SwiGLU FFN or a sparse MoE block whose router takes a float32 softmax over
every expert and renormalises the top k, a final RMSNorm and an untied LM
head). No cache, no batching across sequences in attention, no kernels:
each sequence attends over itself in full. It imports nothing of the
program and takes nothing the program made: each layer's weights are drawn
again from the seed (``weights.py``) and widened to float32. TF32 is off.

It runs after the window, layer by layer over every sampled sequence, so
that one layer's weights are held at a time.

``fp8=True`` gives the control: the same forward with every projection
inside the layers (q, k, v, o and the FFN's or experts' three) computed on
float8 e4m3 operands, the activation scaled per token and the weight per
output column, as an fp8 serving path would; the router, embedding and LM
head stay float32.
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


def _lin(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return _q8(x, -1) @ _q8(w, -2)
    return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, H, hd) at positions 0 .. n-1; angles in float64."""
    n, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None]
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(cfg, lp, x, fp8: bool, q_chunk: int = 1024):
    n = x.shape[0]
    hd, hq = cfg["head_dim"], cfg["num_attention_heads"]
    hkv = cfg["num_key_value_heads"]
    eps = cfg["rms_norm_eps"]
    q = _lin(x, lp["q_proj"], fp8).view(n, hq, hd)
    k = _lin(x, lp["k_proj"], fp8).view(n, hkv, hd)
    v = _lin(x, lp["v_proj"], fp8).view(n, hkv, hd)
    q = _rope(_rms(q, lp["q_norm"], eps), cfg["rope_theta"])
    k = _rope(_rms(k, lp["k_norm"], eps), cfg["rope_theta"])
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # (hq, n, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)                                     # (hq, n, hd)
    out = torch.empty_like(q)
    for a in range(0, n, q_chunk):
        b = min(n, a + q_chunk)
        s = q[:, a:b] @ k[:, :b].transpose(1, 2) * hd ** -0.5
        mask = torch.arange(b, device=x.device)[None] \
            > torch.arange(a, b, device=x.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, :b]
    return _lin(out.transpose(0, 1).reshape(n, hq * hd), lp["o_proj"], fp8)


def _moe(cfg, lp, x, fp8: bool):
    """The MoE block's output, and the experts each token's router chose."""
    probs = torch.softmax(x @ lp["router"], dim=-1)
    top, idx = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(_lin(xe, lp["experts.gate_proj"][e], fp8)) \
            * _lin(xe, lp["experts.up_proj"][e], fp8)
        out.index_add_(0, tok, _lin(h, lp["experts.down_proj"][e], fp8)
                       * top[tok, slot][:, None])
    return out, idx


def _mlp(lp, x, fp8: bool):
    h = F.silu(_lin(x, lp["mlp.gate_proj"], fp8)) \
        * _lin(x, lp["mlp.up_proj"], fp8)
    return _lin(h, lp["mlp.down_proj"], fp8)


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


def _load_layer(cfg, seed, layer, device) -> Dict[str, torch.Tensor]:
    return {name: W.draw(seed, name, layer, spec, device).float()
            for name, spec in W.layer_leaves(cfg).items()}


@torch.no_grad()
def served_gaps(cfg: dict, seed: int, seqs: List[dict], device,
                control: bool = False) -> Dict[str, list]:
    """For each sequence ``{"prompt": ids, "output": ids}``: at every
    position that produced a served token, the reference's best logit less
    its logit of the served token (``"served"``). With ``control``, also
    the float32 reference's best logit less its logit of the token that
    the fp8 forward puts first at the same position (``"control"``).
    One list entry of gaps per sequence. For a MoE configuration also
    ``"routing"`` (and with ``control`` ``"routing_control"``): for each
    sequence the experts each layer's router chose at each prompt
    position, an int64 tensor (layers, prompt length, top k) on the CPU."""
    with _no_tf32():
        streams = {"f32": False, "fp8": True} if control else {"f32": False}
        toks = [torch.as_tensor(list(s["prompt"]) + list(s["output"][:-1]),
                                dtype=torch.long, device=device)
                for s in seqs]
        lens = [t.numel() for t in toks]
        emb = W.draw(seed, "embed_tokens", -1,
                     W.model_leaves(cfg)["embed_tokens"], device)
        hs = {k: [emb[t].float() for t in toks] for k in streams}
        del emb
        eps = cfg["rms_norm_eps"]
        moe = bool(cfg.get("num_experts"))
        # per stream, per layer: the prompt positions' chosen experts
        routed: Dict[str, List[List[torch.Tensor]]] = {k: [] for k in streams}
        for layer in range(cfg["num_hidden_layers"]):
            lp = _load_layer(cfg, seed, layer, device)
            for k, fp8 in streams.items():
                xs = hs[k]
                xs = [x + _attention(cfg, lp, _rms(x, lp["input_layernorm"],
                                                    eps), fp8) for x in xs]
                cat = torch.cat(xs)
                xn = _rms(cat, lp["post_attention_layernorm"], eps)
                if moe:
                    y, idx = _moe(cfg, lp, xn, fp8)
                    routed[k].append([
                        t[:len(s["prompt"])].cpu() for t, s in
                        zip(idx.split(lens), seqs)])
                else:
                    y = _mlp(lp, xn, fp8)
                hs[k] = list((cat + y).split(lens))
            del lp
        leaves = W.model_leaves(cfg)
        fn = W.draw(seed, "norm", -1, leaves["norm"], device)
        head = W.draw(seed, "lm_head", -1, leaves["lm_head"], device).float()
        out: Dict[str, list] = {"served": []}
        if control:
            out["control"] = []
        if moe:
            for k, name in (("f32", "routing"), ("fp8", "routing_control")):
                if k in routed:
                    out[name] = [torch.stack([per[i] for per in routed[k]])
                                 for i in range(len(seqs))]
        for i, s in enumerate(seqs):
            p = len(s["prompt"])
            rows = slice(p - 1, p - 1 + len(s["output"]))
            logits = _rms(hs["f32"][i][rows], fn, eps) @ head
            best = logits.amax(-1)
            served = torch.as_tensor(list(s["output"]), dtype=torch.long,
                                     device=device)
            out["served"].append(
                (best - logits.gather(-1, served[:, None])[:, 0]).cpu())
            if control:
                pick = (_rms(hs["fp8"][i][rows], fn, eps) @ head).argmax(-1)
                out["control"].append(
                    (best - logits.gather(-1, pick[:, None])[:, 0]).cpu())
        return out
