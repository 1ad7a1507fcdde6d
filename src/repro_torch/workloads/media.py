"""Multimedia (Table IV): MPEG-2 decode core -- 8x8 inverse DCT + motion
compensation (a documented kernel reduction).

Twin of ``repro/workloads/media.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.workloads.lowering import F32, I32, clip


def _idct_matrix() -> np.ndarray:
    n = 8
    C = np.zeros((n, n), np.float32)
    for k in range(n):
        for i in range(n):
            a = np.sqrt(1.0 / n) if k == 0 else np.sqrt(2.0 / n)
            C[k, i] = a * np.cos((2 * i + 1) * k * np.pi / (2 * n))
    return C


def build_m2d(scale: int = 1):
    """Per 8x8 block: dequant (int mul), 2D IDCT (two 8x8 matmuls),
    motion compensation (reference block add), saturate to [0, 255]."""
    r = np.random.default_rng(6)
    B = 2 * scale                                   # blocks
    coeffs = torch.from_numpy(r.integers(-32, 32, (B, 8, 8)).astype(np.int32))
    quant = torch.from_numpy(r.integers(1, 8, (8, 8)).astype(np.int32))
    ref = torch.from_numpy(r.integers(0, 255, (B, 8, 8)).astype(np.int32))
    C = torch.from_numpy(_idct_matrix())

    def m2d(coeffs, quant, ref):
        deq = (coeffs * quant).to(F32)                          # (B, 8, 8)
        # C.T @ deq per block: contract C.T's columns with each block's rows
        left = torch.mm(C.t(), deq.permute(1, 0, 2).reshape(8, 8 * B))
        pix = torch.mm(left.reshape(8 * B, 8), C).reshape(8, B, 8)
        out = pix.to(I32).permute(1, 0, 2) + ref                # motion comp.
        blocks = clip(out, 0, 255)
        return blocks, torch.sum(blocks)

    m2d.consts = (C,)                  # closed over, stored after the args
    return m2d, (coeffs, quant, ref)
