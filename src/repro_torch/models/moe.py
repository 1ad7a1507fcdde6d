"""Mixture-of-Experts FFN with two dispatch implementations (port of
``repro.models.moe``).

``einsum``  — GShard/Switch-style one-hot dispatch+combine tensors.
``gather``  — sort-based dispatch: tokens are sorted by expert id and
              scattered into (E, C, d) buffers.

Both keep the reference's order exactly: top-k takes the lower expert on a
tie (a stable descending sort, as ``jax.lax.top_k``), and the gather
dispatch sorts by expert with a stable sort (as ``jnp.argsort``), so the
same tokens are dropped at capacity.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense, einsum, silu, swiglu_layout


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
    # Switch-style load-balancing loss
    me = probs.mean(dim=(0, 1))                             # (E,)
    ce = torch.bincount(idx.reshape(-1), minlength=e.n_experts).float() \
        / idx.numel()
    aux = e.n_experts * torch.sum(me * ce)
    return gate_vals, idx, aux


def _expert_ffn(params, h):
    """h: (G, E, C, d) with E contracted against (E, d, f)."""
    g = einsum("gecd,edf->gecf", h, params["w_gate"])
    u = einsum("gecd,edf->gecf", h, params["w_up"])
    a = silu(g.float()).to(h.dtype) * u
    return einsum("gecf,efd->gecd", a, params["w_down"])


# ------------------------------------------------------------- einsum impl
def _moe_einsum(params, cfg: ModelConfig, x):
    G, S, d = x.shape
    e = cfg.moe
    C = _capacity(cfg, S)
    gates, idx, aux = _router(params, cfg, x)
    combine = torch.zeros((G, S, e.n_experts, C), dtype=torch.float32,
                          device=x.device)
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

    eid = idx.reshape(G, S * k)                      # expert per slot
    tok = torch.arange(S, device=dev).repeat_interleave(k)  # token per slot
    order = torch.sort(eid, dim=-1, stable=True).indices
    eid_s = torch.gather(eid, 1, order)
    tok_s = tok[order]
    gat_s = torch.gather(gates.reshape(G, S * k), 1, order)
    # position within expert = rank - first-rank-of-expert
    first = torch.searchsorted(
        eid_s, torch.arange(e.n_experts, device=dev).expand(G, -1).contiguous(),
        side="left")
    slot = torch.arange(S * k, device=dev) - torch.gather(first, 1, eid_s)
    keep = slot < C
    slot_c = torch.clamp(slot, 0, C - 1)
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, S * k)
    xs = torch.gather(x, 1, tok_s[..., None].expand(G, S * k, d))
    buf = torch.zeros((G, e.n_experts, C, d), dtype=x.dtype, device=dev)
    buf.index_put_((g_idx, eid_s, slot_c),
                   torch.where(keep[..., None], xs, 0), accumulate=True)
    out = _expert_ffn(params, buf)                   # (G,E,C,d)
    vals = out[g_idx, eid_s, slot_c] * (gat_s * keep).to(out.dtype)[..., None]
    y = torch.zeros((G, S, d), dtype=out.dtype, device=dev)
    y.index_put_((g_idx, tok_s), vals, accumulate=True)
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
