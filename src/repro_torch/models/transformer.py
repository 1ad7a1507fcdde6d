"""Model assembly: init, full-sequence forward, prefill, decode — all
families (port of ``repro.models.transformer``).

Parameters are the reference's tree: a nested dict of tensors with the
layers stacked on axis 0.  The reference's ``lax.scan`` over layers is a
loop over layers here.  Each layer's window reaches attention as a static
``int``, so a windowed layer takes the banded path, as in the reference's
two static branches (``transformer.py:254-297``: uniform windows, and
gemma3's periodic local:global pattern).  Its third branch, a traced window
and the masked full path, no config reaches: the windows are uniform
unless ``global_every`` divides some layer index, and then ``n_layers >=
global_every`` holds, which is the periodic branch.

``forward_decode`` updates the cache in place and returns it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (batch_full, is_dtensor,
                                       reduce_partial, shard, unshard_dim)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Leaf, apply_norm, const, dense,
                                       dtype_of, embed, einsum,
                                       in_dot_without_batch_dims,
                                       norm_layout, stacked, swiglu,
                                       swiglu_layout)


# ======================================================================
# Parameter layout and init
# ======================================================================
def _decoder_layer_layout(cfg: ModelConfig, cross: bool = False):
    p = {
        "attn_norm": norm_layout(cfg),
        "attn": attn.attn_layout(cfg),
        "ffn_norm": norm_layout(cfg),
    }
    if cfg.moe.n_experts:
        p["ffn"] = moe_mod.moe_layout(cfg)
    elif cfg.d_ff:
        p["ffn"] = swiglu_layout(cfg.d_model, cfg.d_ff, cfg.param_dtype)
    if cross:
        p["cross_norm"] = norm_layout(cfg)
        p["cross"] = attn.attn_layout(cfg, cross=True)
    if cfg.family == "hybrid":
        p["mamba"] = ssm_mod.mamba_layout(cfg)
        dh = cfg.head_dim
        p["hy_norm_attn"] = const(np.zeros(dh), "float32")
        p["hy_norm_ssm"] = const(np.zeros(dh), "float32")
        p["hy_beta_attn"] = const(1.0, cfg.param_dtype, (cfg.n_heads, dh))
        p["hy_beta_ssm"] = const(1.0, cfg.param_dtype, (cfg.n_heads, dh))
    return p


def _xlstm_pair_layout(cfg: ModelConfig):
    return {
        "m_norm": norm_layout(cfg),
        "mlstm": ssm_mod.mlstm_layout(cfg),
        "s_norm": norm_layout(cfg),
        "slstm": ssm_mod.slstm_layout(cfg),
    }


def _granite_layer_layout(cfg: ModelConfig, kind: str):
    """One layer of a ``hybrid_moe`` model: its mixer (Mamba-2 or
    attention) and its mixture of experts, each after its norm."""
    return {
        "norm": norm_layout(cfg),
        "mixer": (ssm_mod.mamba2_layout(cfg) if kind == "mamba"
                  else attn.attn_layout(cfg)),
        "ffn_norm": norm_layout(cfg),
        "ffn": moe_mod.granite_moe_layout(cfg),
    }


def param_layout(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's ``init_params`` tree as :class:`Leaf` entries.  A
    ``hybrid_moe`` model's layers differ by kind, so they are not stacked:
    ``layers`` maps each layer's zero-padded index to its own tree."""
    dt = cfg.param_dtype
    p: Dict[str, Any] = {
        "embed": embed((cfg.padded_vocab, cfg.d_model), dt),
        "final_norm": norm_layout(cfg),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense((cfg.d_model, cfg.padded_vocab), dt)
    if cfg.family == "hybrid_moe":
        p["layers"] = {f"{i:02d}": _granite_layer_layout(cfg, kind)
                       for i, kind in enumerate(cfg.pattern)}
    elif cfg.family == "ssm":
        p["layers"] = stacked(_xlstm_pair_layout(cfg), cfg.n_layers // 2)
    elif cfg.family == "encdec":
        p["enc_layers"] = stacked(_decoder_layer_layout(cfg), cfg.n_enc_layers)
        p["enc_final_norm"] = norm_layout(cfg)
        p["layers"] = stacked(_decoder_layer_layout(cfg, cross=True),
                              cfg.n_layers)
    else:
        p["layers"] = stacked(_decoder_layer_layout(cfg), cfg.n_layers)
    return p


def _init_leaf(leaf: Leaf, gen: torch.Generator, device):
    if leaf.init == "const":
        t = torch.from_numpy(leaf.value).to(device).expand(leaf.shape)
        return t.to(leaf.torch_dtype).contiguous()
    t = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                    device=device) * leaf.scale
    return t.to(leaf.torch_dtype)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from ``gen``
    (which must live on ``device``) as ``dense_init`` / ``embed_init``
    scale them; constant leaves as the reference sets them."""
    def fill(node):
        if isinstance(node, Leaf):
            return _init_leaf(node, gen, device)
        return {k: fill(v) for k, v in node.items()}
    return fill(param_layout(cfg))


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding window (0 = full attention)."""
    w = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    if cfg.global_every:
        w[cfg.global_every - 1::cfg.global_every] = 0
    return w


def unstack(tree, n: int) -> List[Any]:
    """A layer-stacked tree as ``n`` per-layer trees of views.  Each leaf
    is split by one ``unbind``, whose gradient stacks the layers' gradients
    in one op (indexing it per layer would add ``n`` zero-padded copies of
    the whole leaf).  A leaf sharded on the layer axis is gathered on it
    first, as a scan over a sharded axis does."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return unshard_dim(node, 0).unbind(0)

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]
    parts = split(tree)
    return [take(parts, i) for i in range(n)]


# ======================================================================
# Shared layer bodies
# ======================================================================
def _ffn_apply(lp, cfg: ModelConfig, x):
    """Returns (y, aux)."""
    if cfg.moe.n_experts:
        return moe_mod.moe_ffn(lp["ffn"], cfg, x)
    if cfg.d_ff:
        return swiglu(lp["ffn"], x), 0.0
    return torch.zeros_like(x), 0.0


def _headnorm(x, w, eps=1e-6):
    """Per-head RMS norm over the last (dh) dim; w: (dh,)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w)).to(dt)


def _hymba_mixer(lp, cfg: ModelConfig, h, positions, window, cache=None,
                 cur_pos=None, decode=False):
    """Parallel attention + mamba heads, fused output projection.  Decode
    writes the layer's cache (``k``, ``v``, ``ssm``, ``conv``) in place."""
    ap = lp["attn"]
    new_cache = {}
    q, k, v = attn.qkv_proj(ap, cfg, h, positions)
    if decode:
        attn.write_cache(cache["k"], k, cur_pos)
        attn.write_cache(cache["v"], v, cur_pos)
        a_out = attn.attend_cache(q, cache["k"], cache["v"], cur_pos,
                                  window=window)
        s_out, sstate = ssm_mod.mamba_block(
            lp["mamba"], cfg, h, {"ssm": cache["ssm"], "conv": cache["conv"]},
            decode=True)
        cache["ssm"].copy_(sstate["ssm"])
        cache["conv"].copy_(sstate["conv"])
    else:
        a_out = attn.flash_dispatch(q, k, v, causal=True, window=window)
        s_out, sstate = ssm_mod.mamba_block(lp["mamba"], cfg, h, None,
                                            decode=False)
        new_cache.update(k=k, v=v, ssm=sstate["ssm"], conv=sstate["conv"])
    B, S = h.shape[0], h.shape[1]
    s_heads = s_out.reshape(B, S, cfg.n_heads, cfg.head_dim)
    mixed = 0.5 * (_headnorm(a_out, lp["hy_norm_attn"]) * lp["hy_beta_attn"]
                   + _headnorm(s_heads, lp["hy_norm_ssm"]) * lp["hy_beta_ssm"])
    return attn.out_proj(ap, mixed), new_cache


# ======================================================================
# Full-sequence forward (prefill)
# ======================================================================
def _embed(params, cfg: ModelConfig, tokens):
    table = params["embed"]
    if is_dtensor(table):
        # the same rows; its gradient is DTensor's embedding backward, as
        # some DTensor versions cannot split the index gradient's scatter.
        # A vocab-split table gives rows pending a masked sum, done here
        # once (its mask is read once)
        rows = reduce_partial(torch.nn.functional.embedding(tokens, table))
    else:
        rows = table[tokens]
    return shard(rows, "batch", "seq", "embed")


def _unembed(params, cfg: ModelConfig, x):
    x = apply_norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = einsum("bsd,dv->bsv", x, head)
    return shard(logits, "batch", "seq", "vocab")


def _kv_cache(kvs, cache_len: int):
    """Per-layer (k, v) of length S as the stacked cache (L, B, max(S,
    cache_len), Hkv, dh), zero past S (the reference pads)."""
    B, S, Hkv, dh = kvs[0][0].shape
    pad = max(S, cache_len) - S

    def stacked(ts):
        out = torch.stack(ts)
        if not pad:
            return out
        zeros = batch_full(out, (len(ts), B, pad, Hkv, dh), 0.0, out.dtype,
                           batch_dim=1, ref_batch_dim=1)
        return torch.cat([out, zeros], dim=2)
    return (stacked([k for k, _ in kvs]), stacked([v for _, v in kvs]))


def _stack_states(states):
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """Save the matmul of a :func:`layers.einsum` whose equation has no
    batch dimension; recompute everything else."""
    if op in _DOTS and in_dot_without_batch_dims():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """The reference's ``_maybe_remat``: ``"full"`` keeps only the body's
    inputs and recomputes the rest in the backward pass; ``"block"`` also
    keeps the products with no batch dimension
    (``dots_with_no_batch_dims_saveable``)."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if remat == "block":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_with_no_batch_dims_saveable))
    raise ValueError(f"unknown remat {remat!r}")


def forward_full(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                 remat: str = "none", collect_cache: bool = False,
                 cache_len: int = 0):
    """Full-sequence forward for train and prefill.

    Returns (logits, aux_loss, cache_or_None). ``batch`` carries ``tokens``
    (B, S_text) plus optional ``enc_embeds`` / ``prefix_embeds``.
    ``remat`` wraps each of the reference's scanned bodies (a layer, an
    xLSTM pair, a period of gemma3's pattern) as ``_maybe_remat`` does.
    """
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    if cfg.family == "hybrid_moe":
        if collect_cache:
            raise NotImplementedError("no prefill cache for hybrid_moe")
        return _granite_forward(params, cfg, x, remat)
    if cfg.family == "vlm" and "prefix_embeds" in batch:
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    dev = x.device
    positions = torch.arange(S, device=dev)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)

    if cfg.family == "ssm":
        def pair_body(h, lp):
            y, ms = ssm_mod.mlstm_block(lp["mlstm"], cfg,
                                        apply_norm(cfg, lp["m_norm"], h))
            h = h + y
            y, ss = ssm_mod.slstm_block(lp["slstm"], cfg,
                                        apply_norm(cfg, lp["s_norm"], h))
            return h + y, ms, ss
        body = _maybe_remat(pair_body, remat)
        ms_all, ss_all = [], []
        for lp in unstack(params["layers"], cfg.n_layers // 2):
            x, ms, ss = body(x, lp)
            ms_all.append(ms)
            ss_all.append(ss)
        cache = ({"mlstm": _stack_states(ms_all),
                  "slstm": _stack_states(ss_all)} if collect_cache else None)
        return _unembed(params, cfg, x), aux_total, cache

    layers = unstack(params["layers"], cfg.n_layers)
    if cfg.family == "encdec":
        mem = _encode(params, cfg, batch["enc_embeds"], remat=remat)

        def dec_body(h, aux, lp):
            hn = apply_norm(cfg, lp["attn_norm"], h)
            if collect_cache:
                a, kv = attn.self_attention_prefill(lp["attn"], cfg, hn,
                                                    positions)
            else:
                a = attn.self_attention(lp["attn"], cfg, hn, positions,
                                        causal=True)
                kv = None
            h = h + a
            mk, mv = attn.encode_memory(lp["cross"], cfg, mem)
            c = attn.cross_attention(lp["cross"], cfg,
                                     apply_norm(cfg, lp["cross_norm"], h),
                                     mk, mv)
            h = h + c
            f, a2 = _ffn_apply(lp, cfg, apply_norm(cfg, lp["ffn_norm"], h))
            return h + f, aux + a2, (kv, (mk, mv))
        body = _maybe_remat(dec_body, remat)
        kvs, mems = [], []
        for lp in layers:
            x, aux_total, (kv, mkv) = body(x, aux_total, lp)
            kvs.append(kv)
            mems.append(mkv)
        cache = None
        if collect_cache:
            k, v = _kv_cache(kvs, cache_len)
            cache = {"k": k, "v": v,
                     "mem_k": torch.stack([m[0] for m in mems]),
                     "mem_v": torch.stack([m[1] for m in mems])}
        return _unembed(params, cfg, x), aux_total, cache

    # decoder-only families (dense / moe / hybrid / vlm)
    def layer_step(h, aux, lp, window):
        hn = apply_norm(cfg, lp["attn_norm"], h)
        if cfg.family == "hybrid":
            a_out, kv = _hymba_mixer(lp, cfg, hn, positions, window)
            kv = kv if collect_cache else None
        elif collect_cache:
            a_out, kv = attn.self_attention_prefill(lp["attn"], cfg, hn,
                                                    positions, window=window)
        else:
            a_out = attn.self_attention(lp["attn"], cfg, hn, positions,
                                        window=window)
            kv = None
        h = h + a_out
        f, a2 = _ffn_apply(lp, cfg, apply_norm(cfg, lp["ffn_norm"], h))
        return h + f, aux + a2, kv

    windows = [int(w) for w in layer_windows(cfg)]
    kvs = []
    if (len(set(windows)) > 1 and cfg.global_every
            and cfg.n_layers >= cfg.global_every):
        # the reference's periodic branch: its scan body is one period of
        # the pattern; the leftover layers run after it, outside remat
        p = cfg.global_every
        n_per = cfg.n_layers // p

        def period_body(h, aux, *lps):
            out = []
            for j, lp in enumerate(lps):
                h, aux, kv = layer_step(h, aux, lp, windows[j])
                out.append(kv)
            return h, aux, out
        body = _maybe_remat(period_body, remat)
        for i in range(n_per):
            x, aux_total, kv = body(x, aux_total, *layers[i * p:(i + 1) * p])
            kvs.extend(kv)
        for i in range(n_per * p, cfg.n_layers):
            x, aux_total, kv = layer_step(x, aux_total, layers[i],
                                          windows[i])
            kvs.append(kv)
    else:
        # uniform windows (static) or, where no config reaches, the
        # reference's traced per-layer window: one body per layer
        for lp, window in zip(layers, windows):
            body = _maybe_remat(functools.partial(layer_step, window=window),
                                remat)
            x, aux_total, kv = body(x, aux_total, lp)
            kvs.append(kv)
    cache = None
    if collect_cache:
        pairs = [(kv["k"], kv["v"]) if cfg.family == "hybrid" else kv
                 for kv in kvs]
        k, v = _kv_cache(pairs, cache_len)
        cache = {"k": k, "v": v}
        if cfg.family == "hybrid":
            cache["ssm"] = torch.stack([c["ssm"] for c in kvs])
            cache["conv"] = torch.stack([c["conv"] for c in kvs])
    return _unembed(params, cfg, x), aux_total, cache


def _granite_layer(h, aux, lp, cfg: ModelConfig, kind: str, layer: int):
    """One layer of a ``hybrid_moe`` model: the mixer of its kind, then
    the mixture of experts, each branch scaled by ``residual_multiplier``
    before its residual add.  Spans ``model.mamba`` / ``model.attn`` (and
    ``model.moe``, in :func:`moe.granite_moe`)."""
    hn = apply_norm(cfg, lp["norm"], h)
    if kind == "mamba":
        with obs.span("model.mamba", cat="model", layer=layer):
            m = ssm_mod.mamba2_mixer(lp["mixer"], cfg, hn)
    else:
        with obs.span("model.attn", cat="model", layer=layer):
            q, k, v = attn.qkv_proj(lp["mixer"], cfg, hn)      # no rope
            o = attn.flash_dispatch(q, k, v, causal=True,
                                    scale=cfg.attention_multiplier)
            m = attn.out_proj(lp["mixer"], o)
    h = h + m * cfg.residual_multiplier
    f, a = moe_mod.granite_moe(lp["ffn"], cfg,
                               apply_norm(cfg, lp["ffn_norm"], h),
                               layer=layer)
    return h + f * cfg.residual_multiplier, aux + a


def _granite_forward(params, cfg: ModelConfig, x, remat: str):
    """The ``hybrid_moe`` forward from the token rows: the embedding
    scaled by ``embedding_multiplier``, the layers of ``cfg.pattern`` (one
    remat body each), the logits divided by ``logits_scaling``.  Returns
    (logits, aux, None)."""
    x = x * cfg.embedding_multiplier
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(cfg.pattern):
        body = _maybe_remat(functools.partial(
            _granite_layer, cfg=cfg, kind=kind, layer=i), remat)
        x, aux = body(x, aux, params["layers"][f"{i:02d}"])
    return _unembed(params, cfg, x) / cfg.logits_scaling, aux, None


def _encode(params, cfg: ModelConfig, enc_embeds, *, remat: str = "none"):
    """Bidirectional encoder over stub frame embeddings (B, Se, d)."""
    x = enc_embeds.to(dtype_of(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def enc_body(h, lp):
        a = attn.self_attention(lp["attn"], cfg,
                                apply_norm(cfg, lp["attn_norm"], h),
                                positions, causal=False)
        h = h + a
        f, _ = _ffn_apply(lp, cfg, apply_norm(cfg, lp["ffn_norm"], h))
        return h + f
    body = _maybe_remat(enc_body, remat)
    for lp in unstack(params["enc_layers"], cfg.n_enc_layers):
        x = body(x, lp)
    return apply_norm(cfg, params["enc_final_norm"], x)


# ======================================================================
# Decode (single token against cache / state)
# ======================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Uniform stacked cache tree for one-token decode."""
    L = cfg.n_layers
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.family == "ssm":
        n_pairs = L // 2
        H, dh = cfg.ssm.n_heads, cfg.ssm.head_dim
        return {
            "mlstm": {
                "C": torch.zeros((n_pairs, batch, H, dh, dh), **f32),
                "n": torch.zeros((n_pairs, batch, H, dh), **f32),
                "m": torch.full((n_pairs, batch, H), -1e30, **f32),
            },
            "slstm": {
                k: (torch.full((n_pairs, batch, H, dh), -1e30, **f32)
                    if k == "m" else torch.zeros((n_pairs, batch, H, dh), **f32))
                for k in ("h", "c", "n", "m")
            },
        }
    kv = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(kv, dtype=dtype, device=device),
             "v": torch.zeros(kv, dtype=dtype, device=device)}
    if cfg.family == "hybrid":
        H, dh, N = cfg.ssm.n_heads, cfg.ssm.head_dim, cfg.ssm.d_state
        cache["ssm"] = torch.zeros((L, batch, H, dh, N), **f32)
        cache["conv"] = torch.zeros((L, batch, cfg.ssm.conv_dim - 1, H * dh),
                                    **f32)
    if cfg.family == "encdec":
        mem = (L, batch, max_len // cfg.enc_len_ratio, cfg.n_kv_heads,
               cfg.head_dim)
        cache["mem_k"] = torch.zeros(mem, dtype=dtype, device=device)
        cache["mem_v"] = torch.zeros(mem, dtype=dtype, device=device)
    return cache


def _copy_state(dst, src):
    for k, v in src.items():
        dst[k].copy_(v)


def forward_decode(params, cfg: ModelConfig, token, cache, cur_pos: int):
    """token: (B, 1) int; cur_pos: the new token's position.  Returns
    (logits, cache), the cache updated in place."""
    x = _embed(params, cfg, token)
    if cfg.family == "ssm":
        ml, sl = cache["mlstm"], cache["slstm"]
        for i, lp in enumerate(unstack(params["layers"], cfg.n_layers // 2)):
            m_state = {k: v[i] for k, v in ml.items()}
            s_state = {k: v[i] for k, v in sl.items()}
            y, ms = ssm_mod.mlstm_block(lp["mlstm"], cfg,
                                        apply_norm(cfg, lp["m_norm"], x),
                                        m_state, decode=True)
            x = x + y
            y, ss = ssm_mod.slstm_block(lp["slstm"], cfg,
                                        apply_norm(cfg, lp["s_norm"], x),
                                        s_state, decode=True)
            x = x + y
            _copy_state(m_state, ms)
            _copy_state(s_state, ss)
        return _unembed(params, cfg, x), cache

    layers = unstack(params["layers"], cfg.n_layers)
    positions = torch.full((1, 1), cur_pos, device=x.device)
    # the reference's encdec decode attends with no window, as its prefill
    windows = ([0] * cfg.n_layers if cfg.family == "encdec"
               else [int(w) for w in layer_windows(cfg)])
    for i, (lp, window) in enumerate(zip(layers, windows)):
        hn = apply_norm(cfg, lp["attn_norm"], x)
        if cfg.family == "hybrid":
            layer_cache = {k: cache[k][i] for k in ("k", "v", "ssm", "conv")}
            a, _ = _hymba_mixer(lp, cfg, hn, positions, window,
                                cache=layer_cache, cur_pos=cur_pos,
                                decode=True)
        else:
            a = attn.self_attention_decode(lp["attn"], cfg, hn, cache["k"][i],
                                           cache["v"][i], cur_pos, positions,
                                           window=window)
        x = x + a
        if cfg.family == "encdec":
            c = attn.cross_attention(lp["cross"], cfg,
                                     apply_norm(cfg, lp["cross_norm"], x),
                                     cache["mem_k"][i], cache["mem_v"][i])
            x = x + c
        f, _ = _ffn_apply(lp, cfg, apply_norm(cfg, lp["ffn_norm"], x))
        x = x + f
    return _unembed(params, cfg, x), cache


# ======================================================================
# Loss
# ======================================================================
def lm_loss(logits, labels, vocab_size: Optional[int] = None):
    """Mean token cross-entropy; labels < 0 are masked.  The gold logit is
    a select-and-reduce over the vocab axis, as the reference computes it."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    onehot = vocab_iota == torch.clamp_min(labels, 0)[..., None]
    gold = torch.where(onehot, logits, 0.0).sum(-1)
    nll = lse - gold
    mask = (labels >= 0).float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
