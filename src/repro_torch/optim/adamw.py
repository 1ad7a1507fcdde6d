"""AdamW with f32 moments, global-norm clipping and a cosine-with-warmup
schedule over the port's parameter trees (port of ``repro.optim.adamw``).

The schedule, the bias corrections and the update run as f32 tensors, as
the reference's jnp arithmetic does (a Python float meets an f32 array as
f32), so ``b1 ** t`` is an f32 power, not a double one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.optim.tree import leaves, tree_map, unzip


def init_moments(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = tc.learning_rate * (step + 1) / max(tc.warmup_steps, 1)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * tc.learning_rate * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < tc.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    # a true f32 division (``float / tensor`` multiplies by a reciprocal)
    scale = torch.clamp_max(torch.full_like(gn, max_norm)
                            / torch.clamp_min(gn, 1e-9), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_update(params, grads, moments, step: torch.Tensor,
                 tc: TrainConfig) -> Tuple[Any, Dict[str, Any],
                                           Dict[str, torch.Tensor]]:
    """One AdamW step.  Decoupled weight decay goes to every leaf with
    ``ndim >= 2`` of the *stacked* tree (a per-layer norm weight stacked to
    (L, d) gets it; the final norm's (d,) does not), as the reference
    decides.  Returns (params, moments, {"grad_norm", "lr"})."""
    grads, gn = clip_by_global_norm(grads, tc.grad_clip)
    lr = lr_schedule(tc, step)
    b1, b2 = tc.beta1, tc.beta2
    t = step.float() + 1.0
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.tensor(b1, **f32) ** t
    bc2 = 1.0 - torch.tensor(b2, **f32) ** t

    def upd(p, g, m, v):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + tc.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + tc.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, moments["m"], moments["v"])
    new_p, new_m, new_v = unzip(out, 3)
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gn, "lr": lr}
