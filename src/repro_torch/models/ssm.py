"""Recurrent sequence-mixing layers: mLSTM / sLSTM (xLSTM) and Mamba
(hymba's parallel branch), in plain PyTorch, as the reference computes them
outside any Pallas kernel.

mLSTM keeps the reference's chunkwise form (stabilized parallel form within
a chunk of ``chunk`` tokens, the state carried between chunks, the last
chunk padded with steps that neither decay nor accumulate), plus the
one-token ``mlstm_step`` for decode: the two differ at float rounding, so
the chunking is part of the function. sLSTM is a strictly sequential loop
over time. The Mamba scan is one sequential recurrence whatever the
chunking (the reference's padded steps have dt = 0 and leave ``h`` as it
is); here it runs chunk by chunk to bound the memory of the per-step decay
and input terms, one multiply and one add per token (in place when no
gradient is taken, out of place under autograd).

The reference promotes mixed operand types (a float32 activation against
the bf16 weights that ``init_mlstm`` / ``init_slstm`` draw by default) to
float32 before each product; ``_mm`` does the same.

Shapes: x (B, S, D); heads H with inner head dim hd.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, init_mlp, mlp, rms_norm

LOG_EPS = -1e30


def _mm(x, w):
    """``x @ w`` in the promoted type of the two, as ``jnp.einsum``."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# =====================================================================
# mLSTM (matrix-memory LSTM) — chunkwise stabilized form
# =====================================================================
def init_mlstm(d_model: int, n_heads: int, dtype=torch.bfloat16, *,
               generator: torch.Generator, device="cuda"):
    d_in = 2 * d_model
    kw = dict(generator=generator, device=device)
    return {
        "w_u": dense_init((d_model, d_in), 0, dtype, **kw),
        "w_gate": dense_init((d_model, d_in), 0, dtype, **kw),
        "w_q": dense_init((d_in, d_in), 0, dtype, **kw),
        "w_k": dense_init((d_in, d_in), 0, dtype, **kw),
        "w_i": dense_init((d_model, n_heads), 0, torch.float32, **kw),
        "w_f": dense_init((d_model, n_heads), 0, torch.float32, **kw),
        "w_o": dense_init((d_in, d_model), 0, dtype, **kw),
        "norm": torch.zeros(d_in, device=device),
    }


def mlstm_state_init(batch: int, n_heads: int, hd: int, device="cuda"):
    return {
        "C": torch.zeros((batch, n_heads, hd, hd), device=device),
        "n": torch.zeros((batch, n_heads, hd), device=device),
        "m": torch.full((batch, n_heads), LOG_EPS, device=device),
    }


def _mlstm_chunk(q, k, v, log_i, log_f, state):
    """Stabilized chunkwise-parallel mLSTM on one chunk.

    q, k, v: (B, L, H, hd) f32; log_i, log_f: (B, L, H); state from
    :func:`mlstm_state_init`. Returns (h (B, L, H, hd), new_state).
    """
    B, L, H, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    b = torch.cumsum(log_f, dim=1)                           # (B, L, H)
    m_in, C_in, n_in = state["m"], state["C"], state["n"]

    # per-position stabilizer: max(b_t + m_in, max_{j<=t}(log_i_j + b_t - b_j))
    a = log_i - b
    a_run = torch.cummax(a, dim=1).values
    m_t = torch.maximum(b + m_in[:, None, :], b + a_run)     # (B, L, H)

    # intra-chunk decay D_tj = exp(log_i_j + b_t - b_j - m_t), j <= t
    d_mat = (log_i[:, None, :, :] - b[:, None, :, :]
             + b[:, :, None, :] - m_t[:, :, None, :])        # (B, t, j, H)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    d_mat = torch.where(tri[None, :, :, None], d_mat,
                        torch.full_like(d_mat, LOG_EPS))
    d_exp = torch.exp(d_mat)

    s = torch.einsum("bthd,bjhd->btjh", q, k) * scale        # (B, t, j, H)
    s_w = s * d_exp
    num_intra = torch.einsum("btjh,bjhd->bthd", s_w, v)
    den_intra = torch.sum(s_w, dim=2)                        # (B, t, H)

    # inter-chunk contribution of the entering state
    w_t = torch.exp(b + m_in[:, None, :] - m_t)              # (B, L, H)
    num_inter = torch.einsum("bthd,bhde->bthe", q, C_in) * w_t[..., None] \
        * scale
    den_inter = torch.einsum("bthd,bhd->bth", q, n_in) * w_t * scale

    num = num_intra + num_inter
    den = den_intra + den_inter
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

    # chunk-exit state
    Fl = b[:, -1, :]                                         # (B, H)
    g = log_i + Fl[:, None, :] - b                           # (B, L, H)
    m_out = torch.maximum(m_in + Fl, torch.amax(g, dim=1))
    decay0 = torch.exp(m_in + Fl - m_out)
    gw = torch.exp(g - m_out[:, None, :])                    # (B, L, H)
    C_out = C_in * decay0[..., None, None] + torch.einsum(
        "bjhd,bjhe,bjh->bhde", k, v, gw)
    n_out = n_in * decay0[..., None] + torch.einsum("bjhd,bjh->bhd", k, gw)
    return h, {"C": C_out, "n": n_out, "m": m_out}


def mlstm_step(q, k, v, log_i, log_f, state):
    """One-token recurrence (decode). q, k, v: (B, H, hd); gates (B, H)."""
    hd = q.shape[-1]
    scale = 1.0 / np.sqrt(hd)
    m_in, C_in, n_in = state["m"], state["C"], state["n"]
    m_new = torch.maximum(log_f + m_in, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m_in - m_new)
    C = C_in * f_s[..., None, None] + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = n_in * f_s[..., None] + i_s[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C) * scale
    den = torch.einsum("bhd,bhd->bh", q, n) * scale
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h, {"C": C, "n": n, "m": m_new}


def mlstm_block(params, x, n_heads: int, *, state=None, chunk: int = 128,
                return_state: bool = False, norm_eps: float = 1e-6):
    """Full mLSTM block: up-projection -> chunkwise mLSTM -> gated
    down-projection. x: (B, S, D); ``state`` the carried recurrent state
    (None: zeros)."""
    B, S, D = x.shape
    d_in = params["w_u"].shape[1]
    hd = d_in // n_heads
    u = _mm(x, params["w_u"])
    g = _mm(x, params["w_gate"])
    q = _mm(u, params["w_q"]).reshape(B, S, n_heads, hd)
    k = _mm(u, params["w_k"]).reshape(B, S, n_heads, hd)
    v = u.reshape(B, S, n_heads, hd)
    xf = x.float()
    log_i = xf @ params["w_i"]
    log_f = F.logsigmoid(xf @ params["w_f"])

    if state is None:
        state = mlstm_state_init(B, n_heads, hd, device=x.device)

    if S == 1:
        h, state = mlstm_step(q[:, 0].float(), k[:, 0].float(),
                              v[:, 0].float(), log_i[:, 0], log_f[:, 0],
                              state)
        h = h[:, None]
    else:
        L = min(chunk, S)
        n_chunks = -(-S // L)
        pad = n_chunks * L - S
        qf, kf, vf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad))
                      for t in (q, k, v))
        # padded steps must neither decay nor accumulate: log_f = 0 and
        # log_i = LOG_EPS
        lif = F.pad(log_i, (0, 0, 0, pad), value=LOG_EPS)
        lff = F.pad(log_f, (0, 0, 0, pad), value=0.0)
        hs = []
        for c in range(n_chunks):
            sl = slice(c * L, (c + 1) * L)
            hc, state = _mlstm_chunk(qf[:, sl], kf[:, sl], vf[:, sl],
                                     lif[:, sl], lff[:, sl], state)
            hs.append(hc)
        h = torch.cat(hs, dim=1)[:, :S]

    h = h.reshape(B, S, d_in)
    h = rms_norm(h.to(x.dtype), params["norm"], norm_eps)
    y = h * F.silu(g.float()).to(x.dtype)
    y = _mm(y, params["w_o"])
    if return_state:
        return y, state
    return y


# =====================================================================
# sLSTM (scalar-memory LSTM with exponential gating, block-diagonal
# recurrence)
# =====================================================================
def init_slstm(d_model: int, n_heads: int, dtype=torch.bfloat16, *,
               generator: torch.Generator, device="cuda"):
    hd = d_model // n_heads
    d_ff = -(-4 * d_model // 3)
    kw = dict(generator=generator, device=device)
    return {
        "w_in": dense_init((d_model, 4 * d_model), 0, dtype, **kw),
        "r": torch.randn((n_heads, hd, 4 * hd), **kw) / np.sqrt(hd),
        "b": torch.zeros(4 * d_model, device=device),
        "ffn": init_mlp(d_model, d_ff, dtype, **kw),
        "ffn_norm": torch.zeros(d_model, device=device),
    }


def slstm_state_init(batch: int, n_heads: int, hd: int, device="cuda"):
    z = torch.zeros((batch, n_heads, hd), device=device)
    return {"c": z, "n": torch.zeros_like(z), "h": torch.zeros_like(z),
            "m": torch.full((batch, n_heads), LOG_EPS, device=device)}


def _slstm_step(state, wx, r):
    """wx: (B, 4*D) pre-activation from the input; r: (H, hd, 4*hd)."""
    B = wx.shape[0]
    H, hd, _ = r.shape
    rec = torch.einsum("bhd,hdk->bhk", state["h"], r)        # (B, H, 4*hd)
    pre = wx.reshape(B, H, 4 * hd) + rec
    z_p, i_p, f_p, o_p = torch.split(pre, hd, dim=-1)        # (B, H, hd)
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    # exponential gating with a per-head stabilizer (max over channels)
    log_f = F.logsigmoid(f_p)
    i_t = torch.amax(i_p, dim=-1)                            # (B, H)
    f_t = torch.amax(log_f, dim=-1)
    m_new = torch.maximum(f_t + state["m"], i_t)
    i_g = torch.exp(i_p - m_new[..., None])
    f_g = torch.exp(log_f + state["m"][..., None] - m_new[..., None])
    c = f_g * state["c"] + i_g * z
    n = f_g * state["n"] + i_g
    h = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def slstm_block(params, x, n_heads: int, *, state=None,
                return_state: bool = False, norm_eps: float = 1e-6):
    """x: (B, S, D) -> (B, S, D); a strictly sequential loop over time."""
    B, S, D = x.shape
    hd = D // n_heads
    wx = x.float() @ params["w_in"].float() + params["b"]
    if state is None:
        state = slstm_state_init(B, n_heads, hd, device=x.device)
    hs = []
    for t in range(S):
        state, h_t = _slstm_step(state, wx[:, t], params["r"])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    ffn = {k: w.to(x.dtype) for k, w in params["ffn"].items()}  # promote
    h = h + mlp(ffn, rms_norm(h, params["ffn_norm"], norm_eps))
    if return_state:
        return h, state
    return h


# =====================================================================
# Mamba selective SSM (hymba's parallel mamba heads)
# =====================================================================
def init_mamba(d_model: int, state_dim: int, conv_width: int, expand: int,
               dtype=torch.bfloat16, *, generator: torch.Generator,
               device="cuda"):
    d_in = expand * d_model
    kw = dict(generator=generator, device=device)
    return {
        "in_proj": dense_init((d_model, 2 * d_in), 0, dtype, **kw),
        "conv": (torch.randn((conv_width, d_in), **kw)
                 / np.sqrt(conv_width)).to(dtype),
        "w_bc": dense_init((d_in, 2 * state_dim), 0, dtype, **kw),
        "w_dt": dense_init((d_in, d_in), 0, dtype, **kw),
        "a_log": torch.log(torch.arange(1, state_dim + 1, dtype=torch.float32,
                                        device=device).repeat(d_in, 1)),
        "d_skip": torch.ones(d_in, device=device),
        "out_proj": dense_init((d_in, d_model), 0, dtype, **kw),
    }


def mamba_state_init(batch: int, d_in: int, state_dim: int,
                     conv_width: int, device="cuda"):
    return {
        "h": torch.zeros((batch, d_in, state_dim), device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_in), device=device),
    }


def _mamba_scan(xc, dt, Bm, Cm, a_log, d_skip, h, chunk):
    """The selective scan, one step a token: h_t = h_{t-1} * exp(dt_t * -exp
    (a)) + (dt_t * x_t) B_t, y_t = h_t . C_t + x_t * d_skip. xc, dt: (B, S,
    d_in) f32; Bm, Cm: (B, S, N); h: (B, d_in, N). The decay and input terms
    of a chunk of ``chunk`` tokens are computed at once, elementwise as the
    reference's step computes them, and so are the outputs from the chunk's
    states. Returns (y (B, S, d_in), h)."""
    neg_a = -torch.exp(a_log)                                # (d_in, N)
    S = xc.shape[1]
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        dtc = dt[:, sl].transpose(0, 1)                      # (L, B, d_in)
        da = torch.exp(dtc[..., None] * neg_a)               # (L, B, d_in, N)
        u = (dtc * xc[:, sl].transpose(0, 1))[..., None] \
            * Bm[:, sl].transpose(0, 1)[:, :, None, :]
        if torch.is_grad_enabled() and (da.requires_grad or u.requires_grad
                                        or h.requires_grad):
            # training: the same two ops a step, out of place, so autograd
            # can take them
            steps = []
            for t in range(da.shape[0]):
                h = h * da[t] + u[t]
                steps.append(h)
            hs = torch.stack(steps)
        else:
            hs = torch.empty_like(da)
            for t in range(da.shape[0]):
                torch.mul(h, da[t], out=hs[t])
                hs[t] += u[t]
                h = hs[t]
        ys.append(torch.einsum("lbdn,bln->bld", hs, Cm[:, sl]))
    y = torch.cat(ys, dim=1) + xc * d_skip
    return y, h


def mamba_block(params, x, state_dim: int, conv_width: int, *, state=None,
                chunk: int = 128, return_state: bool = False, policy=None,
                d_in: int = 0):
    """x: (B, S, D) -> (B, S, D), with an optional carried state (decode):
    ``{"h": (B, d_in, N), "conv": (B, w - 1, d_in)}``, both f32.

    Under a policy whose ``model`` axis cuts the ``d_in`` channels (``d_in``
    the global count; ``make_param_specs`` cuts ``in_proj``, ``w_bc`` and
    ``w_dt`` by columns, ``conv``, ``a_log`` and ``out_proj`` by channels,
    ``cache_specs_tree`` the state by channels), each rank scans its own
    channels and carries its block of the state: the projections' column
    blocks are gathered over ``model`` (x and z, the conv output that
    ``w_bc`` and ``w_dt`` read, B and C), and ``out_proj``'s row blocks are
    summed over ``model`` in f32. The scan needs no collective."""
    B, S, D = x.shape
    tp = policy is not None and policy.splits(d_in, policy.model_axis)
    if tp:
        return _mamba_block_tp(params, x, state_dim, conv_width, state,
                               chunk, return_state, policy, d_in)
    d_in = params["out_proj"].shape[0]
    xz = x @ params["in_proj"]
    xs, z = torch.split(xz, d_in, dim=-1)                    # (B, S, d_in)

    if state is None:
        state = mamba_state_init(B, d_in, state_dim, conv_width,
                                 device=x.device)

    xconv, new_conv = _causal_conv(xs, params["conv"], state["conv"],
                                   conv_width)
    xcd = xconv.to(x.dtype)
    bc = (xcd @ params["w_bc"]).float()
    Bmat, Cmat = torch.split(bc, state_dim, dim=-1)
    dt = F.softplus((xcd @ params["w_dt"]).float())

    y, h = _mamba_scan(xconv, dt, Bmat, Cmat, params["a_log"],
                       params["d_skip"], state["h"], chunk)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = y @ params["out_proj"]
    if return_state:
        return out, {"h": h, "conv": new_conv}
    return out


def _causal_conv(xs, conv, conv_state, conv_width: int):
    """Depthwise causal conv along S over the carried conv tail: xs (B, S,
    C), conv (w, C), conv_state (B, w - 1, C) -> (silu of the conv in f32,
    the new tail in f32)."""
    S = xs.shape[1]
    conv_in = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
    idx = torch.arange(S, device=xs.device)[:, None] \
        + torch.arange(conv_width, device=xs.device)[None, :]
    windows = conv_in[:, idx]                                # (B, S, w, C)
    xconv = F.silu(torch.einsum("bswd,wd->bsd", windows, conv).float())
    new_conv = (conv_in[:, -(conv_width - 1):].float() if conv_width > 1
                else conv_state)
    return xconv, new_conv


def _mamba_block_tp(params, x, state_dim, conv_width, state, chunk,
                    return_state, policy, d_in):
    """:func:`mamba_block` on this rank's ``d_in / m`` channels (see
    there). Gradients: the input's is summed over ``model`` (each rank's
    columns of ``in_proj`` give a part of it), and so are those of the
    gathered x/z, conv output and B/C (each rank reads its own channels of
    them, or, for B and C, its own channels' scan) and of ``d_skip``."""
    B, S, D = x.shape
    M = policy.model_axis
    n = d_in // policy.model_size
    c0 = policy.index(M) * n
    xz = policy.all_gather(policy.enter(x, M) @ params["in_proj"], M, -1,
                           sum_axes=M)                       # (B, S, 2 d_in)
    xs, z = xz[..., c0:c0 + n], xz[..., d_in + c0:d_in + c0 + n]
    if state is None:
        state = mamba_state_init(B, n, state_dim, conv_width,
                                 device=x.device)
    xconv, new_conv = _causal_conv(xs, params["conv"], state["conv"],
                                   conv_width)
    xcd = policy.all_gather(xconv.to(x.dtype), M, -1, sum_axes=M)
    if policy.splits(2 * state_dim, M):
        bc = policy.all_gather(xcd @ params["w_bc"], M, -1, sum_axes=M)
    else:
        bc = policy.enter(xcd @ params["w_bc"], M)
    Bmat, Cmat = torch.split(bc.float(), state_dim, dim=-1)
    dt = F.softplus((xcd @ params["w_dt"]).float())          # own channels
    d_skip = policy.take_block(policy.enter(params["d_skip"], M), M, 0)
    y, h = _mamba_scan(xconv, dt, Bmat, Cmat, params["a_log"], d_skip,
                       state["h"], chunk)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = policy.all_reduce((y @ params["out_proj"]).float(), M).to(x.dtype)
    if return_state:
        return out, {"h": h, "conv": new_conv}
    return out
