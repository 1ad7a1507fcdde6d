"""Gradient compression before the optimizer (port of
``repro.optim.compression``): ``none``; ``bf16``, a cast; ``int8_ef``,
per-leaf int8 quantization (scale = max |g + e| / 127, round half to even
as ``jnp.round``) with the residual carried in bf16 as error feedback.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.optim.tree import tree_map, unzip


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device), params)


def compress_grads(grads, method: str, error_fb: Optional[Any] = None
                   ) -> Tuple[Any, Optional[Any]]:
    if method == "none":
        return grads, error_fb
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), error_fb

    if method == "int8_ef":
        if error_fb is None:
            raise ValueError("int8_ef compression needs the state's "
                             "error_fb tree (init_error_feedback)")

        def one(g, e):
            g32 = g.float() + e.float()
            scale = torch.clamp_min(torch.max(torch.abs(g32)), 1e-12) / 127.0
            q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
            deq = q.float() * scale
            return deq.to(g.dtype), (g32 - deq).to(torch.bfloat16)

        return unzip(tree_map(one, grads, error_fb), 2)
    raise ValueError(f"unknown compression {method!r}")
