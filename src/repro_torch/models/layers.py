"""Shared building blocks: norms, rotary embeddings, SwiGLU, the parameter
layout (port of ``repro.models.layers``).

The reference builds its parameters with ``jax.random``; the port cannot
draw the same numbers, so every module states its parameters as a layout
of :class:`Leaf` entries instead.  ``transformer.init_params`` fills a
layout from a ``torch.Generator``; ``convert.numpy_params`` fills the same
layout from numpy, so both packages can be fed one tree.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


_DOT_SCOPE = threading.local()


def in_dot_without_batch_dims() -> bool:
    """True while :func:`einsum` computes a product with no batch
    dimension (what remat ``"block"`` keeps)."""
    return getattr(_DOT_SCOPE, "active", False)


@functools.lru_cache(maxsize=None)
def _has_batch_dims(eq: str) -> bool:
    ins, out = eq.split("->")
    return bool(set.intersection(*(set(t) for t in ins.split(",")), out))


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to one dtype first, as
    ``jnp.einsum`` promotes them (bf16 with f32 is f32)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    ops = [o.to(dt) for o in ops]
    if _has_batch_dims(eq):
        return torch.einsum(eq, *ops)
    _DOT_SCOPE.active = True
    try:
        return torch.einsum(eq, *ops)
    finally:
        _DOT_SCOPE.active = False


def _replace_inf(x):
    return torch.where(x == torch.inf, 0.0, x)


class _Softplus(torch.autograd.Function):
    """``logaddexp(x, 0)`` with ``logaddexp``'s own derivative,
    ``exp(x - out)`` (+inf read as 0), not autograd's of the formula."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_replace_inf(x) - _replace_inf(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, written as jnp writes it."""
    return _Softplus.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ----------------------------------------------------------------- layout
@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its shape, dtype name and how the reference draws it.

    ``init`` is ``"dense"`` (normal / sqrt(fan_in)), ``"embed"`` (normal *
    0.02) or ``"const"`` (``value``, a numpy array broadcast to ``shape``).
    ``fan_in`` is fixed per layer, so a layer-stacked leaf keeps it."""
    shape: tuple
    dtype: str
    init: str = "dense"
    fan_in: Optional[int] = None
    value: Any = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def scale(self) -> float:
        if self.init == "embed":
            return 0.02
        return 1.0 / math.sqrt(self.fan_in)


def dense(shape, dtype, fan_in=None) -> Leaf:
    return Leaf(tuple(shape), dtype, "dense",
                fan_in if fan_in is not None else shape[0])


def embed(shape, dtype) -> Leaf:
    return Leaf(tuple(shape), dtype, "embed")


def const(value, dtype, shape=None) -> Leaf:
    value = np.asarray(value, np.float32)
    return Leaf(tuple(value.shape if shape is None else shape),
                dtype, "const", value=value)


def stacked(layout, n: int):
    """``layout`` with every leaf given a leading layer axis of ``n``."""
    if isinstance(layout, Leaf):
        return dataclasses.replace(layout, shape=(n, *layout.shape))
    return {k: stacked(v, n) for k, v in layout.items()}


# ----------------------------------------------------------------- norms
def rms_norm(x, weight, eps):
    # keep the (B,S,d) tensor in compute dtype; only the reduction runs f32
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + weight).to(x.dtype)


def layer_norm(x, weight, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def norm_layout(cfg: ModelConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    if cfg.norm == "ln":
        return {"w": const(np.ones(d), dt), "b": const(np.zeros(d), dt)}
    return {"w": const(np.zeros(d), dt)}


def apply_norm(cfg: ModelConfig, params, x):
    if cfg.norm == "ln":
        return layer_norm(x, params["w"], params["b"], cfg.norm_eps)
    return rms_norm(x, params["w"], cfg.norm_eps)


# ----------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs       # (..., S, dh/2)
    cos = torch.cos(angles)[..., :, None, :]               # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- FFN
def swiglu_layout(d_model: int, d_ff: int, dtype):
    return {"w_gate": dense((d_model, d_ff), dtype),
            "w_up": dense((d_model, d_ff), dtype),
            "w_down": dense((d_ff, d_model), dtype)}


def swiglu(params, x):
    g = einsum("bsd,df->bsf", x, params["w_gate"])
    u = einsum("bsd,df->bsf", x, params["w_up"])
    h = silu(g.float()).to(x.dtype) * u
    h = shard(h, "batch", "seq", "dff")
    out = einsum("bsf,fd->bsd", h, params["w_down"])
    return shard(out, "batch", "seq", "embed")


def softcap(logits, cap: float):
    """``cap * tanh(logits / cap)``; ``logits`` unchanged without a
    positive cap."""
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits

