"""Mixture-of-Experts FFN with two dispatch implementations (port of
``repro.models.moe``).

``einsum``  — GShard/Switch-style one-hot dispatch+combine tensors.
``gather``  — sort-based dispatch: tokens are sorted by expert id and
              scattered into (E, C, d) buffers.

Both keep the reference's order exactly: top-k takes the lower expert on a
tie (a stable descending sort, as ``jax.lax.top_k``), and the gather
dispatch sorts by expert with a stable sort (as ``jnp.argsort``), so the
same tokens are dropped at capacity.

:func:`granite_moe` is Granite-4.0-H's layer, which the reference package
lacks: top-k over the router's logits, then a softmax over those k; a
dropless dispatch (each held expert gets every token routed to it, its
rows grouped by the per-expert counts, read back once); an expert share
(the router scores every expert, the layer computes its held experts'
part); and the shared expert.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import batch_full, shard
from repro_torch.models.layers import (dense, einsum, silu, swiglu,
                                       swiglu_layout)


def moe_layout(cfg: ModelConfig):
    d, e, dt = cfg.d_model, cfg.moe, cfg.param_dtype
    p = {
        "router": dense((d, e.n_experts), "float32"),
        "w_gate": dense((e.n_experts, d, e.expert_d_ff), dt, fan_in=d),
        "w_up": dense((e.n_experts, d, e.expert_d_ff), dt, fan_in=d),
        "w_down": dense((e.n_experts, e.expert_d_ff, d), dt,
                        fan_in=e.expert_d_ff),
    }
    if e.n_shared_experts:
        p["shared"] = swiglu_layout(d, e.n_shared_experts * e.expert_d_ff, dt)
    return p


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    e = cfg.moe
    c = int(tokens_per_group * e.top_k * e.capacity_factor / e.n_experts) + 1
    return max(8, ((c + 7) // 8) * 8)  # align


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: on a tie the lower index
    comes first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int):
    """``jax.nn.one_hot`` in f32: an index outside [0, n) is a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _router(params, cfg: ModelConfig, x):
    """x (G, S, d) -> gates (G, S, k), idx (G, S, k), aux_loss (scalar)."""
    e = cfg.moe
    logits = einsum("gsd,de->gse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = top_k(probs, e.top_k)                  # (G,S,k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return gate_vals, idx, _balance_loss(probs, idx, e.n_experts)


def _balance_loss(probs, idx, n_experts: int):
    """Switch-style load-balancing loss: ``n_experts`` times the dot of
    the mean router probability and the share of slots per expert."""
    me = probs.mean(dim=(0, 1))                             # (E,)
    flat = idx.reshape(-1)                                  # .at[idx].add(1)
    ce = torch.zeros(n_experts, device=idx.device).scatter_add(
        0, flat, torch.ones_like(flat, dtype=torch.float32)) / idx.numel()
    return n_experts * torch.sum(me * ce)


def _expert_ffn(params, h):
    """h: (G, E, C, d) with E contracted against (E, d, f)."""
    h = shard(h, "batch", "expert", "cap", "embed")
    g = einsum("gecd,edf->gecf", h, params["w_gate"])
    u = einsum("gecd,edf->gecf", h, params["w_up"])
    a = silu(g.float()).to(h.dtype) * u
    out = einsum("gecf,efd->gecd", a, params["w_down"])
    return shard(out, "batch", "expert", "cap", "embed")


# ------------------------------------------------------------- einsum impl
def _moe_einsum(params, cfg: ModelConfig, x):
    G, S, d = x.shape
    e = cfg.moe
    C = _capacity(cfg, S)
    gates, idx, aux = _router(params, cfg, x)
    combine = batch_full(x, (G, S, e.n_experts, C), 0.0, torch.float32)
    for ki in range(e.top_k):
        oh = _one_hot(idx[..., ki], e.n_experts)                  # (G,S,E)
        pos = (torch.cumsum(oh, dim=1) - 1.0) * oh                 # (G,S,E)
        keep = (pos < C) & (oh > 0)
        pos_oh = _one_hot(pos.to(torch.int32), C) * keep[..., None]
        combine = combine + gates[..., ki, None, None] * oh[..., None] * pos_oh
    dispatch = (combine > 0).to(x.dtype)                           # (G,S,E,C)
    h = einsum("gsec,gsd->gecd", dispatch, x)
    out = _expert_ffn(params, h)
    y = einsum("gsec,gecd->gsd", combine.to(x.dtype), out)
    return y, aux


# ------------------------------------------------------------- gather impl
def _moe_gather(params, cfg: ModelConfig, x):
    G, S, d = x.shape
    e = cfg.moe
    k = e.top_k
    C = _capacity(cfg, S)
    dev = x.device
    gates, idx, aux = _router(params, cfg, x)

    # every scatter and gather below stays within a group (batch row), so
    # a batch-split step runs it on its own rows only
    eid = idx.reshape(G, S * k)                      # expert per slot
    order = torch.sort(eid, dim=-1, stable=True).indices
    eid_s = torch.gather(eid, 1, order)
    tok_s = torch.div(order, k, rounding_mode="floor")  # token per slot
    gat_s = torch.gather(gates.reshape(G, S * k), 1, order)
    # position within expert = rank - first-rank-of-expert; the first rank
    # is the left searchsorted of each expert id in the sorted ids, i.e.
    # the count of smaller ids (an exclusive cumsum of per-expert counts)
    counts = batch_full(eid, (G, e.n_experts), 0, eid.dtype).scatter_add(
        1, eid, torch.ones_like(eid))
    first = torch.cumsum(counts, dim=1) - counts
    slot = torch.arange(S * k, device=dev) - torch.gather(first, 1, eid_s)
    keep = slot < C
    row = eid_s * C + torch.clamp(slot, 0, C - 1)    # (expert, slot) of buf
    rows = row[..., None].expand(G, S * k, d)
    xs = torch.gather(x, 1, tok_s[..., None].expand(G, S * k, d))
    buf = batch_full(x, (G, e.n_experts * C, d), 0.0, x.dtype).scatter_add(
        1, rows, torch.where(keep[..., None], xs, 0))
    out = _expert_ffn(params, buf.reshape(G, e.n_experts, C, d))
    vals = torch.gather(out.reshape(G, e.n_experts * C, d), 1, rows) \
        * (gat_s * keep).to(out.dtype)[..., None]
    y = batch_full(x, (G, S, d), 0.0, out.dtype).scatter_add(
        1, tok_s[..., None].expand(G, S * k, d), vals)
    return y, aux


def moe_ffn(params, cfg: ModelConfig, x):
    """x: (B, S, d) -> (y, aux_loss). Groups = batch rows."""
    impl = _moe_einsum if cfg.moe.impl == "einsum" else _moe_gather
    y, aux = impl(params, cfg, x)
    if cfg.moe.n_shared_experts:
        sp = params["shared"]
        g = einsum("bsd,df->bsf", x, sp["w_gate"])
        u = einsum("bsd,df->bsf", x, sp["w_up"])
        y = y + einsum("bsf,fd->bsd", silu(g.float()).to(x.dtype) * u,
                       sp["w_down"])
    return y, aux


# ------------------------------------------------- Granite-4.0-H's layer
def granite_moe_layout(cfg):
    """Router over every expert (f32), the held experts' SwiGLU weights
    (``cfg`` a ``HybridMoEConfig``) and the shared expert."""
    d, e, dt = cfg.d_model, cfg.moe, cfg.param_dtype
    n = len(cfg.held)
    return {
        "router": dense((d, e.n_experts), "float32"),
        "w_gate": dense((n, d, e.expert_d_ff), dt, fan_in=d),
        "w_up": dense((n, d, e.expert_d_ff), dt, fan_in=d),
        "w_down": dense((n, e.expert_d_ff, d), dt, fan_in=e.expert_d_ff),
        "shared": swiglu_layout(d, cfg.shared_d_ff, dt),
    }


_ROUTES: Optional[Dict[int, torch.Tensor]] = None


@contextlib.contextmanager
def capture_routing() -> Iterator[Dict[int, torch.Tensor]]:
    """While open, every :func:`granite_moe` call given a ``layer`` keeps
    its first choice of experts (a recomputation keeps none), as
    ``{layer: (G, S, k) expert ids}``, in the dict it yields."""
    global _ROUTES
    _ROUTES = routes = {}
    try:
        yield routes
    finally:
        _ROUTES = None


def dropless_experts(params, cfg, x, idx, gates):
    """The held experts' part of the layer, dropping no token.

    ``idx``/``gates``: (T, k) expert ids over the whole router and their
    weights.  The slots of held experts are sorted by expert (stable), each
    expert's rows are one contiguous group sized by its count (one
    readback) and its products run over exactly those rows; the weighted
    outputs are summed per token in f32.  Returns (y, counts), ``counts``
    the rows each held expert got."""
    T, d = x.shape
    held = cfg.held
    n, k = len(held), idx.shape[1]
    local = torch.full((cfg.moe.n_experts,), n, dtype=torch.int64,
                       device=x.device)
    local[list(held)] = torch.arange(n, device=x.device)
    slot = local[idx.reshape(-1)]                       # n: not held here
    counts = torch.bincount(slot, minlength=n + 1).tolist()[:n]
    order = torch.sort(slot, stable=True).indices[:sum(counts)]
    tok = torch.div(order, k, rounding_mode="floor")
    rows = x[tok]
    outs = []
    for j, h in enumerate(rows.split(counts)):
        g = einsum("td,df->tf", h, params["w_gate"][j])
        u = einsum("td,df->tf", h, params["w_up"][j])
        a = silu(g.float()).to(h.dtype) * u
        outs.append(einsum("tf,fd->td", a, params["w_down"][j]))
    w = gates.reshape(-1)[order]
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device).index_add(
        0, tok, torch.cat(outs).float() * w[:, None])
    return y.to(x.dtype), counts


def granite_moe(params, cfg, x, layer: Optional[int] = None):
    """x: (B, S, d) -> (y, aux): top-k over the router's f32 logits, a
    softmax over those k, the held experts' dropless part and the shared
    expert; ``aux`` the Switch-style loss over the whole router.  Span
    ``model.moe``: ``routed`` (rows sent to held experts) and
    ``max_expert`` (the most one held expert got)."""
    B, S, d = x.shape
    k = cfg.moe.top_k
    with obs.span("model.moe", cat="model", layer=layer) as sp:
        logits = einsum("bsd,de->bse", x.float(), params["router"])
        top, idx = top_k(logits, k)
        gates = torch.softmax(top, dim=-1)
        aux = _balance_loss(torch.softmax(logits, dim=-1), idx,
                            cfg.moe.n_experts)
        if _ROUTES is not None and layer is not None:
            _ROUTES.setdefault(layer, idx.detach())
        y, counts = dropless_experts(params, cfg, x.reshape(B * S, d),
                                     idx.reshape(B * S, k),
                                     gates.reshape(B * S, k))
        sp.set(routed=sum(counts), max_expert=max(counts, default=0))
        return y.reshape(B, S, d) + swiglu(params["shared"], x), aux
