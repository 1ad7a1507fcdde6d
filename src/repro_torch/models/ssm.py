"""Recurrent sequence mixers: xLSTM (mLSTM + sLSTM) and Mamba-2 style SSD
(port of ``repro.models.ssm``).

The prefill paths are chunkwise-parallel, as the reference's: the
reference's ``lax.scan`` over chunks is a loop over chunks here, parallel
inside a chunk.  sLSTM is strictly sequential (a loop over tokens).
Decode paths are single-step recurrences over the carried state.  Neither
package's model path calls the mLSTM kernel of ``kernels/``: that kernel
starts from a zero state and returns no final state, which the prefill
cache needs.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import batch_full
from repro_torch.models.layers import const, dense, einsum, silu, softplus

NEG_INF = -1e30


def _log_sigmoid(x):
    return -softplus(-x)


def cummax(x, dim: int):
    """``lax.cummax`` as JAX differentiates it: its parallel prefix scan of
    pairwise ``maximum`` (``lax.associative_scan``), so a cotangent splits
    at ties as the reference's does (``torch.cummax`` sends it to one
    index).  The values are ``torch.cummax``'s."""
    n = x.shape[dim]
    if n < 2:
        return x

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]
    odd = cummax(torch.maximum(sl(x, 0, -1, 2), sl(x, 1, None, 2)), dim)
    if n % 2 == 0:
        even = torch.maximum(sl(odd, 0, -1), sl(x, 2, None, 2))
    else:
        even = torch.maximum(odd, sl(x, 2, None, 2))
    even = torch.cat([sl(x, 0, 1), even], dim=dim)
    # ``even`` at the even positions, ``odd`` at the odd ones
    if odd.shape[dim] < even.shape[dim]:
        odd = torch.cat([odd, torch.zeros_like(sl(x, 0, 1))], dim=dim)
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)[
        (slice(None),) * dim + (slice(0, n),)]


def _chunks(x, nchunk: int, K: int):
    """(B, nchunk*K, ...) -> the ``nchunk`` chunks along axis 1."""
    return [x[:, c * K:(c + 1) * K] for c in range(nchunk)]


# ======================================================================
# mLSTM — matrix-memory LSTM (xLSTM [arXiv:2405.04517]), chunkwise form.
# ======================================================================
def mlstm_layout(cfg: ModelConfig):
    d = cfg.d_model
    H, dh = cfg.ssm.n_heads, cfg.ssm.head_dim
    di = H * dh
    dt = cfg.param_dtype
    return {
        "w_up": dense((d, 2 * di), dt),
        "wq": dense((di, H, dh), dt, fan_in=di),
        "wk": dense((di, H, dh), dt, fan_in=di),
        "wv": dense((di, H, dh), dt, fan_in=di),
        "w_if": dense((d, 2 * H), "float32", fan_in=d),
        "b_if": const(np.concatenate([np.zeros(H), np.linspace(3.0, 6.0, H)]),
                      "float32"),
        "w_down": dense((di, d), dt),
        "ogate_w": dense((d, di), dt),
    }


def mlstm_init_state(batch: int, H: int, dh: int, ref):
    """Zero state for ``batch`` rows, on ``ref``'s device and split on the
    batch as ``ref`` (batch first) is."""
    f32 = torch.float32
    return {
        "C": batch_full(ref, (batch, H, dh, dh), 0.0, f32),
        "n": batch_full(ref, (batch, H, dh), 0.0, f32),
        "m": batch_full(ref, (batch, H), NEG_INF, f32),
    }


def _mlstm_chunk_step(qc, kc, vc, li, lf, state):
    """One chunk: qc/kc/vc (B,K,H,dh); li/lf (B,K,H) log gates; state dict."""
    B, K, H, dh = qc.shape
    scale = 1.0 / math.sqrt(dh)
    b = torch.cumsum(lf, dim=1)                      # (B,K,H) inclusive decay
    g = li - b                                       # log source weight
    m_intra = cummax(g, dim=1) + b                   # (B,K,H)
    m_inter = state["m"][:, None] + b                # (B,K,H)
    m_t = torch.maximum(m_intra, m_inter)

    # intra-chunk: D[t,j] = exp(b_t + g_j - m_t) for j <= t (head-major)
    bh = b.permute(0, 2, 1)                          # (B,H,K)
    gh = g.permute(0, 2, 1)
    mh = m_t.permute(0, 2, 1)
    logD = bh[:, :, :, None] + gh[:, :, None, :] - mh[:, :, :, None]
    causal = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                   device=qc.device))
    D = torch.where(causal, torch.exp(logD), 0.0)

    qh = qc.permute(0, 2, 1, 3).float()              # (B,H,K,dh)
    kh = kc.permute(0, 2, 1, 3).float()
    vh = vc.permute(0, 2, 1, 3).float()
    s = torch.einsum("bhtd,bhjd->bhtj", qh, kh) * scale
    w = s * D
    num = torch.einsum("bhtj,bhjd->bhtd", w, vh)
    den = w.sum(-1)                                  # (B,H,K)

    # inter-chunk contribution
    inter_w = torch.exp(m_inter - m_t)               # (B,K,H)
    inter_wh = inter_w.permute(0, 2, 1)              # (B,H,K)
    num = num + inter_wh[..., None] * torch.einsum(
        "bhtd,bhde->bhte", qh * scale, state["C"])
    den = den + inter_wh * torch.einsum("bhtd,bhd->bht", qh * scale,
                                        state["n"])

    h = num / torch.maximum(den.abs(), torch.exp(-mh))[..., None]
    h = h.permute(0, 2, 1, 3)                        # (B,K,H,dh)

    # state update to chunk end
    Ftot = b[:, -1]                                  # (B,H)
    m_next = torch.maximum(state["m"] + Ftot, Ftot + g.amax(dim=1))
    w_prev = torch.exp(state["m"] + Ftot - m_next)   # (B,H)
    w_src = torch.exp(Ftot[:, None] + g - m_next[:, None])   # (B,K,H)
    C_new = w_prev[..., None, None] * state["C"] + torch.einsum(
        "bkh,bhkd,bhke->bhde", w_src, kh, vh)
    n_new = w_prev[..., None] * state["n"] + torch.einsum(
        "bkh,bhkd->bhd", w_src, kh)
    return h, {"C": C_new, "n": n_new, "m": m_next}


def mlstm_sequence(q, k, v, i_raw, f_raw, state=None, chunk: int = 128):
    """q/k/v: (B,S,H,dh); i_raw/f_raw: (B,S,H). Returns (h, final_state)."""
    B, S, H, dh = q.shape
    if state is None:
        state = mlstm_init_state(B, H, dh, q)
    li = i_raw.float()                               # log input gate
    lf = _log_sigmoid(f_raw.float())                 # log sigmoid forget gate
    K = min(chunk, S)
    nchunk = -(-S // K)
    pad = nchunk * K - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG_INF)  # no source weight
        lf = F.pad(lf, (0, 0, 0, pad))                 # decay 1 on padding
    hs = []
    for qc, kc, vc, lic, lfc in zip(*(_chunks(t, nchunk, K)
                                      for t in (q, k, v, li, lf))):
        h, state = _mlstm_chunk_step(qc, kc, vc, lic, lfc, state)
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :S]
    return h.to(q.dtype), state


def mlstm_step(q1, k1, v1, i_raw, f_raw, state):
    """Single decode step. q1/k1/v1: (B,H,dh); i_raw/f_raw: (B,H)."""
    scale = 1.0 / math.sqrt(q1.shape[-1])
    li = i_raw.float()
    lf = _log_sigmoid(f_raw.float())
    m_new = torch.maximum(lf + state["m"], li)
    fw = torch.exp(lf + state["m"] - m_new)
    iw = torch.exp(li - m_new)
    kf, vf, qf = k1.float(), v1.float(), q1.float()
    C = fw[..., None, None] * state["C"] \
        + iw[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = fw[..., None] * state["n"] + iw[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf * scale, C)
    den = torch.einsum("bhd,bhd->bh", qf * scale, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q1.dtype), {"C": C, "n": n, "m": m_new}


def mlstm_block(params, cfg: ModelConfig, x, state=None, decode: bool = False):
    """Full mLSTM block: up-proj, per-head qkv+gates, recurrence, gated down."""
    H, dh = cfg.ssm.n_heads, cfg.ssm.head_dim
    di = H * dh
    u = einsum("bsd,de->bse", x, params["w_up"])
    a = u[..., :di]                                   # (B,S,di)
    q = einsum("bse,ehd->bshd", a, params["wq"])
    k = einsum("bse,ehd->bshd", a, params["wk"])
    v = einsum("bse,ehd->bshd", a, params["wv"])
    gates = einsum("bsd,dg->bsg", x.float(), params["w_if"]) + params["b_if"]
    i_raw, f_raw = gates[..., :H], gates[..., H:]     # (B,S,H)
    og = silu(einsum("bsd,de->bse", x, params["ogate_w"]).float()).to(x.dtype)
    if decode:
        h, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                              f_raw[:, 0], state)
        h = h[:, None]
    else:
        h, state = mlstm_sequence(q, k, v, i_raw, f_raw, state,
                                  chunk=cfg.ssm.chunk)
    h = h.reshape(*h.shape[:2], di) * og
    return einsum("bse,ed->bsd", h, params["w_down"]), state


# ======================================================================
# sLSTM — scalar-memory LSTM with recurrent gating (strictly sequential).
# ======================================================================
def slstm_layout(cfg: ModelConfig):
    d = cfg.d_model
    H, dh = cfg.ssm.n_heads, cfg.ssm.head_dim
    f_bias = np.tile(np.linspace(3.0, 6.0, H), dh).reshape(dh, H).T.reshape(-1)
    return {
        "w_gates": dense((d, 4 * d), "float32", fan_in=d),      # z,i,f,o
        "r_gates": dense((4, H, dh, dh), "float32", fan_in=dh),
        "b_gates": const(np.concatenate([np.zeros(2 * d), f_bias,
                                         np.zeros(d)]), "float32"),
        "w_out": dense((d, d), cfg.param_dtype),
    }


def slstm_init_state(batch: int, d: int, H: int, dh: int, ref):
    z = batch_full(ref, (batch, H, dh), 0.0, torch.float32)
    return {"h": z, "c": z, "n": z + 1e-6,
            "m": batch_full(ref, (batch, H, dh), NEG_INF, torch.float32)}


def _slstm_cell(params, cfg: ModelConfig, xw, st):
    """xw: (B, 4d) precomputed input contribution; st: state dict."""
    H, dh = cfg.ssm.n_heads, cfg.ssm.head_dim
    B = xw.shape[0]
    rec = torch.einsum("ghde,bhe->bghd", params["r_gates"], st["h"])
    gates = xw.reshape(B, 4, H, dh) + rec + params["b_gates"].reshape(4, H, dh)
    z_t = torch.tanh(gates[:, 0])
    i_raw, f_raw = gates[:, 1], gates[:, 2]
    o_t = torch.sigmoid(gates[:, 3])
    lf = _log_sigmoid(f_raw)                          # log sigmoid forget
    m_new = torch.maximum(lf + st["m"], i_raw)
    iw = torch.exp(i_raw - m_new)
    fw = torch.exp(lf + st["m"] - m_new)
    c = fw * st["c"] + iw * z_t
    n = fw * st["n"] + iw
    h = o_t * c / torch.clamp_min(n, 1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def slstm_block(params, cfg: ModelConfig, x, state=None, decode: bool = False):
    B, S, d = x.shape
    H, dh = cfg.ssm.n_heads, cfg.ssm.head_dim
    if state is None:
        state = slstm_init_state(B, d, H, dh, x)
    xw = einsum("bsd,de->bse", x.float(), params["w_gates"])     # (B,S,4d)
    hs = []
    for t in range(1 if decode else S):
        state = _slstm_cell(params, cfg, xw[:, t], state)
        hs.append(state["h"])
    out = torch.stack(hs, dim=1).reshape(B, len(hs), d).to(x.dtype)
    return einsum("bsd,de->bse", out, params["w_out"]), state


# ======================================================================
# Mamba-2 style SSD (hymba's SSM heads) — scalar-per-head decay, chunked.
# ======================================================================
def mamba_layout(cfg: ModelConfig):
    d = cfg.d_model
    H, dh, N = cfg.ssm.n_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    di = H * dh
    dt = cfg.param_dtype
    return {
        "w_in": dense((d, 2 * di), dt),                         # x, z
        "conv_w": dense((cfg.ssm.conv_dim, di), dt, fan_in=cfg.ssm.conv_dim),
        "w_bc": dense((d, 2 * N), dt),                          # B, C
        "w_dt": dense((d, H), "float32"),
        "dt_bias": const(np.log(np.expm1(np.linspace(1e-3, 0.1, H))),
                         "float32"),
        "A_log": const(np.log(np.linspace(1.0, 16.0, H)), "float32"),
        "D": const(np.ones(H), "float32"),
        "w_out": dense((di, d), dt),
    }


def mamba_init_state(batch: int, cfg: ModelConfig, ref):
    H, dh, N = cfg.ssm.n_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    return {
        "ssm": batch_full(ref, (batch, H, dh, N), 0.0, torch.float32),
        "conv": batch_full(ref, (batch, cfg.ssm.conv_dim - 1, H * dh), 0.0,
                           torch.float32),
    }


def _causal_conv(params, cfg: ModelConfig, xc, conv_state=None):
    """Depthwise causal conv over (B,S,di); returns (y, new_tail_state)."""
    K = cfg.ssm.conv_dim
    if conv_state is None:
        pad = batch_full(xc, (xc.shape[0], K - 1, xc.shape[2]), 0.0,
                         xc.dtype)
    else:
        pad = conv_state.to(xc.dtype)
    xp = torch.cat([pad, xc], dim=1)                  # (B, S+K-1, di)
    S = xc.shape[1]
    y = sum(xp[:, i:i + S] * params["conv_w"][i] for i in range(K))
    new_state = xp[:, -(K - 1):].float()
    return silu(y.float()).to(xc.dtype), new_state


def ssd_sequence(xh, B_t, C_t, la, state, chunk: int):
    """Chunked SSD: xh (B,S,H,dh) dt-scaled inputs; B_t/C_t (B,S,N);
    la (B,S,H) log decay (<= 0); state (B,H,dh,N)."""
    Bb, S, H, dh = xh.shape
    K = min(chunk, S)
    nchunk = -(-S // K)
    pad = nchunk * K - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B_t = F.pad(B_t, (0, 0, 0, pad))
        C_t = F.pad(C_t, (0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad), value=0.0)
    causal = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                   device=xh.device))[None, :, :, None]
    ys = []
    for xc, bc, cc, lac in zip(*(_chunks(t, nchunk, K)
                                 for t in (xh, B_t, C_t, la))):
        xf, bf, cf = xc.float(), bc.float(), cc.float()
        b = torch.cumsum(lac, dim=1)                  # (B,K,H)
        # intra-chunk: y_t += sum_{j<=t} exp(b_t-b_j) (C_t.B_j) x_j
        sc = torch.einsum("btn,bjn->btj", cf, bf)
        logw = b[:, :, None, :] - b[:, None, :, :]    # (B,t,j,H)
        # mask before exp: the non-causal logw is positive and overflows
        logw = torch.where(causal, logw, -torch.inf)
        w = torch.exp(logw) * sc[..., None]
        y = torch.einsum("btjh,bjhd->bthd", w, xf)
        # inter-chunk: y_t += exp(b_t) C_t . h_prev
        y = y + torch.exp(b)[..., None] * torch.einsum("btn,bhdn->bthd", cf,
                                                       state)
        # state update
        Ftot = b[:, -1]                               # (B,H)
        wsrc = torch.exp(Ftot[:, None] - b)           # (B,K,H)
        state = torch.exp(Ftot)[:, :, None, None] * state + torch.einsum(
            "bkh,bkhd,bkn->bhdn", wsrc, xf, bf)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], state


def mamba_block(params, cfg: ModelConfig, x, state=None, decode: bool = False):
    """Returns ((B,S,H*dh) heads output BEFORE out-proj, new_state)."""
    B, S, d = x.shape
    H, dh, N = cfg.ssm.n_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    di = H * dh
    if state is None:
        state = mamba_init_state(B, cfg, x)
    u = einsum("bsd,de->bse", x, params["w_in"])
    xc, z = u[..., :di], u[..., di:]
    xc, conv_state = _causal_conv(params, cfg, xc, state["conv"])
    bc = einsum("bsd,dn->bsn", x, params["w_bc"])
    B_t, C_t = bc[..., :N], bc[..., N:]
    dt = softplus(einsum("bsd,dh->bsh", x.float(), params["w_dt"])
                  + params["dt_bias"])                # (B,S,H)
    la = -torch.exp(params["A_log"]) * dt             # log decay <= 0
    xh = xc.reshape(B, S, H, dh) * dt[..., None].to(xc.dtype)
    if decode:
        a = torch.exp(la[:, 0])                       # (B,H)
        st = a[..., None, None] * state["ssm"] + torch.einsum(
            "bhd,bn->bhdn", xh[:, 0].float(), B_t[:, 0].float())
        y = torch.einsum("bn,bhdn->bhd", C_t[:, 0].float(), st)[:, None]
        new_ssm = st
    else:
        y, new_ssm = ssd_sequence(xh, B_t, C_t, la, state["ssm"],
                                  cfg.ssm.chunk)
    y = y + params["D"][:, None] * xh.float()
    y = y.reshape(B, S, di).to(x.dtype) * silu(z.float()).to(x.dtype)
    return y, {"ssm": new_ssm, "conv": conv_state}


# ======================================================================
# Mamba-2 as published (Granite-4.0-H's mixer): one input projection to
# [z, x|B|C, dt], a depthwise causal conv with bias over x|B|C, the SSD
# (``ssd_sequence``, shared with hymba), D x, a gated RMSNorm, out_proj.
# ======================================================================
def mamba2_layout(cfg: ModelConfig):
    """The published mixer's parameters (``cfg`` a ``HybridMoEConfig``).
    The gated norm's weight is stored as its offset from one, as every
    norm of the port is."""
    d, s, dt = cfg.d_model, cfg.ssm, cfg.param_dtype
    H, di, cc = s.n_heads, cfg.ssm_inner, cfg.conv_channels
    return {
        "in_proj": dense((d, di + cc + H), dt),            # z, x|B|C, dt
        "conv_w": dense((s.conv_dim, cc), dt, fan_in=s.conv_dim),
        "conv_b": dense((cc,), dt, fan_in=s.conv_dim),
        "dt_bias": const(np.log(np.expm1(np.linspace(1e-3, 0.1, H))),
                         "float32"),
        "A_log": const(np.log(np.arange(1.0, H + 1.0)), "float32"),
        "D": const(np.ones(H), "float32"),
        "norm": const(np.zeros(di), dt),
        "out_proj": dense((di, d), dt),
    }


def _conv_with_bias(w, b, xbc):
    """Depthwise causal conv of width ``len(w)`` with bias over (B,S,C),
    then SiLU; the sequence starts from zeros."""
    K, S = w.shape[0], xbc.shape[1]
    pad = batch_full(xbc, (xbc.shape[0], K - 1, xbc.shape[2]), 0.0,
                     xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return silu((y + b).float()).to(xbc.dtype)


def mamba2_mixer(params, cfg: ModelConfig, x):
    """(B,S,d) -> (B,S,d): the published Mamba-2 mixer over a sequence
    that starts from a zero state (one group of B and C)."""
    if cfg.ssm_groups != 1:
        raise NotImplementedError("Mamba-2 with more than one group of B, C")
    B, S, _ = x.shape
    s = cfg.ssm
    H, dh, N = s.n_heads, s.head_dim, s.d_state
    di, cc = cfg.ssm_inner, cfg.conv_channels
    u = einsum("bsd,de->bse", x, params["in_proj"])
    z, xbc, dt_raw = u[..., :di], u[..., di:di + cc], u[..., di + cc:]
    xbc = _conv_with_bias(params["conv_w"], params["conv_b"], xbc)
    xc, B_t, C_t = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = softplus(dt_raw.float() + params["dt_bias"])   # (B,S,H)
    la = -torch.exp(params["A_log"]) * dt               # log decay <= 0
    xs = xc.reshape(B, S, H, dh)
    xh = xs * dt[..., None].to(xc.dtype)
    state = batch_full(x, (B, H, dh, N), 0.0, torch.float32)
    y, _ = ssd_sequence(xh, B_t, C_t, la, state, s.chunk)
    y = (y + params["D"][:, None] * xs.float()).reshape(B, S, di)
    g = y * silu(z.float())                             # gated RMSNorm
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + cfg.norm_eps)
    g = g.to(x.dtype) * (1.0 + params["norm"]).to(x.dtype)
    return einsum("bse,ed->bsd", g, params["out_proj"])
