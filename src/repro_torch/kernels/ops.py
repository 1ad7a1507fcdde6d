"""Public wrappers around the kernels (twin of ``repro/kernels/ops.py``).

Same names and signatures as the reference's, minus ``interpret``: the
device of the tensors chooses between kernel and plain version.  Attention
and mLSTM pad and block exactly as the reference does, quirks included
(ROADMAP Queue 3): ``flash_attention`` pads Sq and Skv to the block
multiples with zeros and never masks the padded keys, so with causal masks
and Sq > Skv the rows past Skv attend to them, and it refuses non-causal
ragged Skv (here before any launch); ``mlstm_chunkwise`` halves the chunk
until it divides S.  The bulk ops need no padding: the kernel is one flat
pass over any number of elements, and padding cannot change an
elementwise result.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cim_bitwise as _cb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm_chunk as _mc


def _pad_to(x: torch.Tensor, mult: int, axis: int):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x, 0
    widths = [0, 0] * (x.dim() - axis)
    widths[-1] = pad                 # F.pad lists the last axis first
    return F.pad(x, widths), pad


# -------------------------------------------------------------- bitwise
def cim_bulk(x, y, op: str = "and"):
    """Bulk CiM op over same-shape int arrays of any rank (>=1)."""
    return _cb.cim_bitwise(x, y, op=op)


def cim_fused(x, y, z, op1: str = "add", op2: str = "xor"):
    return _cb.cim_bitwise_fused(x, y, z, op1=op1, op2=op2)


# ------------------------------------------------------------ attention
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = _fa.DEFAULT_BLOCK_Q,
                    block_k: int = _fa.DEFAULT_BLOCK_K):
    """q: (B,H,Sq,d); k/v: (B,Hkv,Skv,d).  Pads Sq/Skv to block multiples;
    the zero-padded keys are not masked (the reference's behaviour)."""
    Sq, Skv = q.shape[2], k.shape[2]
    bq = min(block_q, max(8, Sq))
    bk = min(block_k, max(8, Skv))
    qp, _ = _pad_to(q, bq, 2)
    kp, pk = _pad_to(k, bk, 2)
    vp, _ = _pad_to(v, bk, 2)
    if pk and not causal:
        raise ValueError("non-causal ragged Skv unsupported; pad upstream")
    out = _fa.flash_attention(qp, kp, vp, causal=causal, window=window,
                              block_q=bq, block_k=bk)
    return out[:, :, :Sq]


# ---------------------------------------------------------------- mLSTM
def mlstm_chunkwise(q, k, v, i_raw, f_raw, *,
                    chunk: int = _mc.DEFAULT_CHUNK):
    S = q.shape[2]
    K = min(chunk, S)
    while S % K:
        K //= 2
    return _mc.mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk=max(K, 1))
