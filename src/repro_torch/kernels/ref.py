"""Plain torch oracles for every kernel of the package (twin of
``repro/kernels/ref.py``).

Each ``*_ref`` computes the same function as its kernel without blocking
or an online softmax, so agreement with these validates both the tiling
and the numerics.  They are also the kernels' plain versions: each
wrapper calls its oracle on CPU tensors.  uint32 add and sub go through an
int32 view: torch has no CPU add for uint32, and two's-complement wrap
makes the view exact.
"""
from __future__ import annotations

import math

import torch

#: the masked-score sentinel and the mLSTM stabilizer's start, finite as in
#: the reference (an all-masked row stays finite)
NEG_INF = -1e30
_OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
}


def log_gates(i_raw: torch.Tensor, f_raw: torch.Tensor):
    """(log input gate, log sigmoid forget gate) in f32, as the reference
    wrapper computes them: ``li = i_raw``, ``lf = -softplus(-f_raw)`` with
    softplus written as ``logaddexp(x, 0)``."""
    f = f_raw.to(torch.float32)
    return i_raw.to(torch.float32), -torch.logaddexp(-f, torch.zeros_like(f))


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def cim_bitwise_ref(x, y, *, op: str = "and"):
    return _OPS[op](_as_int32(x), _as_int32(y)).view(x.dtype)


def cim_bitwise_fused_ref(x, y, z, *, op1: str = "add", op2: str = "xor"):
    t = _OPS[op1](_as_int32(x), _as_int32(y))
    return _OPS[op2](t, _as_int32(z)).view(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,Sq,d); k/v: (B,Hkv,Skv,d). Dense softmax reference."""
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = torch.repeat_interleave(k, G, dim=1).to(torch.float32)
    vf = torch.repeat_interleave(v, G, dim=1).to(torch.float32)
    qf = q.to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / math.sqrt(d)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)


def mlstm_chunkwise_ref(q, k, v, i_raw, f_raw):
    """Sequential stabilized mLSTM recurrence (token-by-token oracle).

    q/k/v: (B, H, S, dh); gates: (B, H, S).  Matches the kernel's chunkwise
    math in exact arithmetic (the chunked form is algebraically identical).
    """
    B, H, S, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    li, lf = log_gates(i_raw, f_raw)
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    hs = []
    for t in range(S):
        qt, kt, vt = qf[:, :, t], kf[:, :, t], vf[:, :, t]
        lit, lft = li[:, :, t], lf[:, :, t]
        m_new = torch.maximum(lft + m, lit)
        fw = torch.exp(lft + m - m_new)
        iw = torch.exp(lit - m_new)
        C = fw[..., None, None] * C + iw[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = fw[..., None] * n + iw[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qt * scale, C)
        den = torch.einsum("bhd,bhd->bh", qt * scale, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, dim=2).to(q.dtype)               # (B,H,S,dh)
