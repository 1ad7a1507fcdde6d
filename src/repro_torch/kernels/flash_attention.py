"""Flash attention: CUDA kernel + plain version.

Twin of ``repro/kernels/flash_attention.py``: online-softmax attention
with f32 m/l/acc, causal and sliding-window masks from positions, GQA,
masked scores at the finite ``NEG_INF = -1e30``, and the result
``acc / max(l, 1e-30)`` in q's dtype.  A CUDA tensor launches the kernel
(``csrc/flash_attention.cu``: one block per (b*h, 64-row q tile), KV tiles
looped inside, K/V head ``h // G`` read in place; f32 on the tensor cores
as 3xTF32 ``mma.sync`` (each operand split into two TF32 terms, three
products), bf16 through wgmma, with P split into two bf16 terms for the
P.V product); a CPU tensor takes the plain version, the
dense-softmax ``ref.flash_attention_ref``.

Sq and Skv must tile by the blocks, as in the reference (``ops.py``
pads); the kernel itself takes any lengths.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.accel import _build
from repro_torch.kernels import CSRC, count_launch, ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
#: head dims the CUDA kernel is compiled for
HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)

_SRC = CSRC / "flash_attention.cu"
_SIG = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p)


def _launch(q, k, v, causal: bool, window: int,
            sm_scale: float) -> torch.Tensor:
    B, H, Sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not among the kernel's {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"f32 or bf16 expected on the card, got {q.dtype}")
    # contiguous, and 16-byte aligned for the bf16 kernel's cp.async
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)
    lib, fn = _build.function(_SRC, "flash_attention", _SIG)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            k.shape[1], Sq, k.shape[2], d, int(causal), int(window),
            sm_scale, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention launch")
    count_launch("flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q: (B, H, Sq, d); k, v: (B, Hkv, Skv, d); GQA via H % Hkv == 0.
    Sq/Skv must tile by block_q/block_k (ops.py pads)."""
    B, H, Sq, d = q.shape
    Bk, Hkv, Skv, dk = k.shape
    if (B, d) != (Bk, dk) or H % Hkv or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if not (q.dtype == k.dtype == v.dtype) or not (
            q.device == k.device == v.device):
        raise ValueError("q, k and v must share dtype and device")
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    if Sq % bq or Skv % bk:
        raise ValueError(f"Sq={Sq}, Skv={Skv} do not tile by ({bq}, {bk})")
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window, 1.0 / math.sqrt(d))
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"unsupported device {q.device}")
