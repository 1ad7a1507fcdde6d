"""GQA attention: chunked-flash train/prefill, cached decode, cross-attn
(port of ``repro.models.attention``).

The train/prefill path is the reference's *chunked online softmax*: a loop
over KV blocks that never materializes the (Sq, Skv) score matrix, with the
scores and the running max, sum and accumulator in f32.  Its gradient is
the reference's ``custom_vjp`` (``_flash_bwd``): :class:`_Flash` saves the
output and the log-sum-exp and recomputes each block's probabilities from
them.  It is plain torch, as the reference's is plain jnp: neither
package's model path calls the flash-attention kernel of ``kernels/``
(whose contract has no ``q_offset``, ``kv_len`` or softcap, and no
backward).

Which path a layer takes follows the reference: a window passed as a
Python ``int`` is *static* and may take the banded (block-skipping) path;
a window passed as a 0-dim tensor is the reference's *traced* window and
takes the masked full path.  The two sum in different orders, so the port
must pick the same one per layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import batch_full, is_dtensor, shard
from repro_torch.models.layers import apply_rope, const, dense, einsum

NEG_INF = -1e30


# ---------------------------------------------------------------- params
def attn_layout(cfg: ModelConfig, cross: bool = False):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {
        "wq": dense((d, h, dh), dt, fan_in=d),
        "wk": dense((d, hk, dh), dt, fan_in=d),
        "wv": dense((d, hk, dh), dt, fan_in=d),
        "wo": dense((h, dh, d), dt, fan_in=h * dh),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = const(0.0, dt, (h, dh))
        p["bk"] = const(0.0, dt, (hk, dh))
        p["bv"] = const(0.0, dt, (hk, dh))
    return p


def qkv_proj(params, cfg: ModelConfig, x, positions=None, rope: bool = True):
    """x: (B, S, d) -> q (B,S,H,dh), k/v (B,S,Hkv,dh)."""
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    k = einsum("bsd,dhk->bshk", x, params["wk"])
    v = einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def out_proj(params, attn_out):
    out = einsum("bshk,hkd->bsd", attn_out, params["wo"])
    out = shard(out, "batch", "seq", "embed_out")   # identity unless decode
    return shard(out, "batch", "seq", "embed")


# ------------------------------------------------------- chunked flash
def _block_mask(q_pos, k_pos, causal, window, kv_len, skv_bound):
    """(Sq, blk) bool mask; ``window``/``kv_len`` are numbers or 0-dim
    f32 tensors (the reference's traced scalars)."""
    mask = k_pos[None, :] < kv_len
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if torch.is_tensor(window):
        w = torch.where(window > 0, window, skv_bound)
    else:
        w = window if window > 0 else skv_bound
    return mask & (q_pos[:, None] - k_pos[None, :] < w)


def _acc_dtype(x) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _flash_fwd(causal, block, softcap, q, k, v, window, q_offset, kv_len,
               scale=None):
    """The forward of the reference's ``_flash_fwd_impl``: its
    ``lax.scan`` over KV blocks as a loop.  Returns (out, lse).  The
    scores are scaled by ``scale``, 1/sqrt(dh) where it is ``None``."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    nblk = -(-Skv // block)
    pad = nblk * block - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    # scores and P.V run in f32 from the inputs' values, as the
    # reference's preferred_element_type=f32 products do (f64 inputs, as
    # in a gradient check, stay f64)
    acc_t = _acc_dtype(q)
    qh = q.reshape(B, Sq, Hkv, G, dh).to(acc_t)
    q_pos = q_offset + torch.arange(Sq, dtype=torch.float32, device=dev)
    skv_bound = float(Skv + Sq + 1)

    m = batch_full(q, (B, Hkv, G, Sq), NEG_INF, acc_t)
    l = batch_full(q, (B, Hkv, G, Sq), 0.0, acc_t)
    acc = batch_full(q, (B, Hkv, G, Sq, dh), 0.0, acc_t)
    for i in range(nblk):
        kblk = k[:, i * block:(i + 1) * block]
        vblk = v[:, i * block:(i + 1) * block]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kblk.to(acc_t)) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        k_pos = float(i * block) + torch.arange(block, dtype=torch.float32,
                                                device=dev)
        mask = _block_mask(q_pos, k_pos, causal, window, kv_len, skv_bound)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vblk.dtype).to(acc_t), vblk.to(acc_t))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    lse = m + torch.log(torch.clamp_min(l, 1e-30))           # (B,Hkv,G,Sq)
    out = out.reshape(B, Hkv * G, Sq, dh).permute(0, 2, 1, 3).to(q.dtype)
    return out, lse


def _flash_bwd(causal, block, q, k, v, out, lse, dout, window, q_offset,
               kv_len, scale=None):
    """The reference's ``_flash_bwd``, FA2 style: each block's ``p``
    recomputed from the saved LSE.  Like the reference it recomputes the
    scores without the softcap's ``tanh``.  Returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    nblk = -(-Skv // block)
    pad = nblk * block - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    # products of the inputs' values accumulate in f32, as the reference's
    # preferred_element_type=f32 products do
    acc_t = _acc_dtype(q)
    qh = q.reshape(B, Sq, Hkv, G, dh).to(acc_t)
    doh = dout.reshape(B, Sq, Hkv, G, dh).to(acc_t)
    outh = out.reshape(B, Sq, Hkv, G, dh)
    # D_t = sum_d dout_t * out_t  (rowsum of p*dp)
    D = torch.einsum("bqhgd,bqhgd->bhgq", doh, outh.to(acc_t))
    q_pos = q_offset + torch.arange(Sq, dtype=torch.float32, device=dev)
    skv_bound = float(Skv + Sq + 1)

    dq = batch_full(q, (B, Sq, Hkv, G, dh), 0.0, acc_t)
    dks, dvs = [], []
    for i in range(nblk):
        kblk = k[:, i * block:(i + 1) * block].to(acc_t)
        vblk = v[:, i * block:(i + 1) * block].to(acc_t)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kblk) * scale
        k_pos = float(i * block) + torch.arange(block, dtype=torch.float32,
                                                device=dev)
        mask = _block_mask(q_pos, k_pos, causal, window, kv_len, skv_bound)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse[..., None])                  # (B,Hkv,G,Sq,blk)
        dvs.append(torch.einsum("bhgqk,bqhgd->bkhd", p, doh))
        dp = torch.einsum("bqhgd,bkhd->bhgqk", doh, vblk)
        ds = p * (dp - D[..., None]) * scale
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kblk)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qh))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return (dq.reshape(B, Sq, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` (``custom_vjp``): forward
    :func:`_flash_fwd`, saving (q, k, v, out, lse); backward
    :func:`_flash_bwd`.  ``window``, ``q_offset`` and ``kv_len`` get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block, softcap, window, q_offset,
                kv_len, scale=None):
        out, lse = _flash_fwd(causal, block, softcap, q, k, v, window,
                              q_offset, kv_len, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, block, window, q_offset, kv_len, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block, window, q_offset, kv_len, scale = ctx.args
        dq, dk, dv = _flash_bwd(causal, block, q, k, v, out, lse, dout,
                                window, q_offset, kv_len, scale)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_jnp(q, k, v, *, causal: bool, window=0, q_offset=0,
                        kv_len=None, block: int = 1024, softcap: float = 0.0,
                        scale=None):
    """Online-softmax attention over KV blocks (the reference's name).

    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh). ``window``: if > 0, only
    keys with q_pos - k_pos < window attend (plus the causal constraint).
    ``kv_len``: number of valid kv positions (for padded caches). Returns
    (B, Sq, H, dh).  ``scale`` multiplies the scores (1/sqrt(dh) where
    ``None``).
    """
    Skv = k.shape[1]
    block = min(block, Skv)
    if torch.is_tensor(window):
        window = window.float()
    if torch.is_tensor(kv_len):
        kv_len = kv_len.float()
    return per_shard(lambda q, k, v: _Flash.apply(
        q, k, v, causal, block, float(softcap), window, q_offset,
        Skv if kv_len is None else kv_len, scale), q, k, v)


def per_shard(fn, q, k, v):
    """``fn(q, k, v)``; on DTensors split alike on the batch (dim 0) and the
    heads (dim 2) only, ``fn`` runs on each device's rows and heads and
    its output takes q's placements.  Attention is independent per row
    and head, and a contiguous head split keeps the GQA groups whole, so
    each device computes its own part, as a partitioned XLA program does;
    DTensor's own batched products would have to merge the two split dims
    into one, which some of its versions refuse."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor
    pl = tuple(q.placements)
    local = all(p.is_replicate() or (p.is_shard() and p.dim in (0, 2))
                for p in pl)
    if not (local and tuple(k.placements) == pl == tuple(v.placements)):
        return fn(q, k, v)
    out = fn(q.to_local(), k.to_local(), v.to_local())
    return DTensor.from_local(out, q.device_mesh, pl, run_check=False)


def flash_attention_banded(q, k, v, *, window: int, block: int = 1024,
                           softcap: float = 0.0, scale=None):
    """Sliding-window attention with KV *block-skipping*: each q block
    attends only to its own KV band (ceil(window/blk)+1 blocks).  Requires
    a static integer window (causal)."""
    B, S, H, dh = q.shape
    blk = min(block, S, max(window, 128))
    while S % blk:
        blk //= 2
    nq = S // blk
    wblk = -(-window // blk)                        # band blocks before diag
    nband = min(wblk + 1, nq)
    if nband >= nq:                                 # band covers everything
        return flash_attention_jnp(q, k, v, causal=True, window=window,
                                   block=blk, softcap=softcap, scale=scale)
    outs = []
    for i in range(nq):
        start = max(i - (nband - 1), 0) * blk
        # positions inside the band are relative; shifting q by the band
        # start preserves (q_pos - k_pos) for the causal + window masks
        outs.append(flash_attention_jnp(
            q[:, i * blk:(i + 1) * blk], k[:, start:start + nband * blk],
            v[:, start:start + nband * blk], causal=True, window=window,
            q_offset=i * blk - start, block=blk, softcap=softcap,
            scale=scale))
    return torch.cat(outs, dim=1)


def flash_dispatch(q, k, v, *, causal: bool, window=0, block: int = 1024,
                   softcap: float = 0.0, kv_len=None, scale=None):
    """The banded path when the window is a static int, else the masked
    full path (tensor windows, cross-attn, ragged kv)."""
    if (isinstance(window, int) and window > 0 and causal
            and kv_len is None and q.shape[1] == k.shape[1]):
        return flash_attention_banded(q, k, v, window=window, block=block,
                                      softcap=softcap, scale=scale)
    return flash_attention_jnp(q, k, v, causal=causal, window=window,
                               kv_len=kv_len, block=block, softcap=softcap,
                               scale=scale)


# --------------------------------------------------------------- decode
def attend_cache(q, cache_k, cache_v, cur_pos: int, *, window=0,
                 softcap: float = 0.0):
    """Single-token decode attention over a (padded) KV cache.

    q: (B, 1, H, dh); cache_k/v: (B, Smax, Hkv, dh); cur_pos: index of the
    token being generated (the cache holds positions [0, cur_pos]).
    """
    B, _, H, dh = q.shape
    Smax, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qh = q.reshape(B, Hkv, G, dh)
    s = einsum("bhgd,bkhd->bhgk", qh, cache_k).float() * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(Smax, device=q.device)
    mask = k_pos <= cur_pos
    if torch.is_tensor(window):
        w = torch.where(window > 0, window, Smax + 1)
    else:
        w = window if window > 0 else Smax + 1
    mask = mask & (cur_pos - k_pos < w)
    s = torch.where(mask, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))       # jax.nn.softmax
    p = e / e.sum(dim=-1, keepdim=True)
    out = einsum("bhgk,bkhd->bhgd", p.to(cache_v.dtype), cache_v)
    return out.reshape(B, 1, H, dh).to(q.dtype)


def write_cache(cache, new, cur_pos: int):
    """``dynamic_update_slice`` at ``cur_pos`` on axis 1, in place: the
    start is clamped so the one-token slice fits, as XLA clamps it."""
    cache[:, min(cur_pos, cache.shape[1] - 1)] = new[:, 0].to(cache.dtype)


# ----------------------------------------------------------- full blocks
def self_attention(params, cfg: ModelConfig, x, positions, *, causal=True,
                   window=0, block=1024):
    q, k, v = qkv_proj(params, cfg, x, positions)
    o = flash_dispatch(q, k, v, causal=causal, window=window, block=block,
                       softcap=cfg.attn_logit_softcap)
    return out_proj(params, o)


def self_attention_prefill(params, cfg: ModelConfig, x, positions, *,
                           window=0, block=1024):
    """Returns (out, (k, v)) so the caller can seed the KV cache."""
    q, k, v = qkv_proj(params, cfg, x, positions)
    o = flash_dispatch(q, k, v, causal=True, window=window, block=block,
                       softcap=cfg.attn_logit_softcap)
    return out_proj(params, o), (k, v)


def self_attention_decode(params, cfg: ModelConfig, x, cache_k, cache_v,
                          cur_pos: int, positions, *, window=0):
    """One-token step: writes (k, v) at ``cur_pos`` into the cache in
    place and attends over it.  ``positions``: (1, 1), ``cur_pos``."""
    q, k, v = qkv_proj(params, cfg, x, positions)
    write_cache(cache_k, k, cur_pos)
    write_cache(cache_v, v, cur_pos)
    o = attend_cache(q, cache_k, cache_v, cur_pos, window=window,
                     softcap=cfg.attn_logit_softcap)
    return out_proj(params, o)


def cross_attention(params, cfg: ModelConfig, x, mem_k, mem_v, *,
                    mem_len=None, block=1024):
    """Decoder->encoder attention; memory K/V precomputed (B, Sm, Hkv, dh)."""
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    o = flash_attention_jnp(q, mem_k, mem_v, causal=False, kv_len=mem_len,
                            block=block)
    return out_proj(params, o)


def encode_memory(params, cfg: ModelConfig, mem):
    """Precompute cross-attention K/V from encoder output (no rope)."""
    k = einsum("bsd,dhk->bshk", mem, params["wk"])
    v = einsum("bsd,dhk->bshk", mem, params["wv"])
    return k, v
