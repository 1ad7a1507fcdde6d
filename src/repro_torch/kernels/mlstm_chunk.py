"""Chunkwise mLSTM: CUDA kernel + plain version.

Twin of ``repro/kernels/mlstm_chunk.py``: the xLSTM matrix-memory
recurrence in its stabilized chunkwise form, with the f32 state C
(dh x dh), n (dh) and m carried across chunks.  The log gates are computed
with torch ops (``ref.log_gates``), as the reference wrapper computes them
in jnp.  A CUDA tensor launches the kernel (``csrc/mlstm_chunk.cu``: the
gates and the stabilizer chain, then each chunk's own state update in
parallel, a scan of the state over the chunks, and the outputs of every
chunk in parallel from its start state -- four CUDA kernels behind one
C call); a CPU tensor takes the plain version, the token-by-token
``ref.mlstm_chunkwise_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.accel import _build
from repro_torch.kernels import CSRC, count_launch, ref

DEFAULT_CHUNK = 128
#: head dims the CUDA kernel is compiled for, and its largest chunk
HEAD_DIMS = (16, 32, 64, 96, 128, 192)
MAX_CHUNK = 128

_SRC = CSRC / "mlstm_chunk.cu"
_SIG = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (the kernel reads rows
    as 16-byte vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, li, lf, K: int) -> torch.Tensor:
    BH, S, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not among the kernel's {HEAD_DIMS}")
    if K > MAX_CHUNK:
        raise ValueError(f"chunk {K} > {MAX_CHUNK}, the kernel's largest")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"f32 or bf16 expected on the card, got {q.dtype}")
    q, k, v = (_aligned(x) for x in (q, k, v))
    li, lf = li.contiguous(), lf.contiguous()
    out = torch.empty_like(q)
    # scratch: per token b, g, m_t and the inter-chunk weight; per chunk
    # the stabilizer at its start, max g, w_prev and the update's scale;
    # per chunk its state update, then its start state (C then n)
    f32 = dict(dtype=torch.float32, device=q.device)
    nc = S // K
    tok = torch.empty((BH, 4, S), **f32)
    chk = torch.empty((BH, nc, 4), **f32)
    st = torch.empty((BH, nc, dh * dh + dh), **f32)
    lib, fn = _build.function(_SRC, "mlstm_chunkwise", _SIG)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
            lf.data_ptr(), out.data_ptr(), BH, S, dh, K,
            1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16),
            tok.data_ptr(), chk.data_ptr(), st.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "mlstm_chunkwise launch")
    count_launch("mlstm_chunkwise")
    return out


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_raw: torch.Tensor, f_raw: torch.Tensor, *,
                    chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """q/k/v: (B, H, S, dh); i_raw/f_raw: (B, H, S) raw gate
    pre-activations.  Returns the hidden sequence (B, H, S, dh).  S must
    tile by ``chunk``."""
    B, H, S, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or \
            i_raw.shape != (B, H, S) or f_raw.shape != (B, H, S):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, gates {tuple(i_raw.shape)} "
                         f"and {tuple(f_raw.shape)} do not fit")
    devices = {x.device for x in (q, k, v, i_raw, f_raw)}
    if len(devices) != 1 or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v and the gates must share a device, and "
                         "q, k and v a dtype")
    K = min(chunk, S)
    if S % K:
        raise ValueError(f"S={S} does not tile by chunk {K}")
    if q.device.type == "cpu":
        return ref.mlstm_chunkwise_ref(q, k, v, i_raw, f_raw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    li, lf = ref.log_gates(i_raw, f_raw)
    flat = [x.reshape(B * H, S, *x.shape[3:]) for x in (q, k, v, li, lf)]
    return _launch(*flat, K).reshape(B, H, S, dh)
