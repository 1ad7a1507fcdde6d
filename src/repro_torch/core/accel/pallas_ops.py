"""Segment reductions of the placement stage: CUDA kernels + plain versions.

Twin of ``repro/core/accel/pallas_ops.py``.  The reference's Pallas
kernels recast the scatter as a one-hot (8,128)x(128,128) contraction for
the TPU's matrix unit; the port's kernels (``csrc/segment_reduce.cu``)
are plain integer-atomic scatters, which a GPU does well.  At placement's
sizes a call costs its launch, not its bytes, so the host path is short:
one output allocation (the kernel writes every segment, identity
included) and one ctypes call, whose function, argument types and stream
getter are bound once.

Both match ``jax.ops.segment_sum`` / ``segment_max`` on int32: ids outside
``[0, n_segments)`` are dropped and an empty segment of the max is
``INT32_MIN``.  A CUDA tensor launches the kernel; a CPU tensor takes the
plain version (``index_add_`` / ``scatter_reduce_``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.accel import _build, count_launch

INT32_MIN = -(2 ** 31)

_SIG = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


def _check_args(vals: torch.Tensor, ids: torch.Tensor,
                n_segments: int) -> None:
    if vals.dim() != 1 or ids.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and ids "
                         f"{tuple(ids.shape)} must be equal 1-D shapes")
    if vals.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError(f"int32 vals and ids expected, got {vals.dtype} "
                        f"and {ids.dtype}")
    if vals.device != ids.device:
        raise ValueError(f"vals on {vals.device}, ids on {ids.device}")
    if n_segments < 0:
        raise ValueError(f"n_segments={n_segments} < 0")


def _plain(vals, ids, n_segments: int, is_max: bool) -> torch.Tensor:
    keep = (ids >= 0) & (ids < n_segments)
    idx = ids[keep].to(torch.int64)
    if is_max:
        out = torch.full((n_segments,), INT32_MIN, dtype=torch.int32)
        return out.scatter_reduce_(0, idx, vals[keep], "amax")
    out = torch.zeros(n_segments, dtype=torch.int32)
    return out.index_add_(0, idx, vals[keep])


def _launch(vals, ids, n_segments: int, is_max: bool) -> torch.Tensor:
    vals, ids = vals.contiguous(), ids.contiguous()
    out = vals.new_empty(n_segments)
    if n_segments == 0:
        return out                   # nothing to write: no launch
    lib, fn = _build.function(_build.CSRC / "segment_reduce.cu",
                              "segment_reduce", _SIG)
    rc = fn(vals.data_ptr(), ids.data_ptr(), vals.numel(), out.data_ptr(),
            n_segments, is_max,
            torch._C._cuda_getCurrentRawStream(vals.get_device()))
    _build.check(lib, rc, "segment_reduce launch")
    count_launch("segment_max" if is_max else "segment_sum")
    return out


def _segment_reduce(vals, ids, n_segments: int, is_max: bool):
    _check_args(vals, ids, n_segments)
    if vals.is_cuda:
        return _launch(vals, ids, n_segments, is_max)
    if vals.device.type == "cpu":
        return _plain(vals, ids, n_segments, is_max)
    raise ValueError(f"unsupported device {vals.device}")


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """int32 sum of ``vals`` by segment ``ids`` (``jax.ops.segment_sum``)."""
    return _segment_reduce(vals, ids, n_segments, is_max=False)


def segment_max(vals: torch.Tensor, ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """int32 max of ``vals`` by segment ``ids`` (``jax.ops.segment_max``);
    an empty segment is ``INT32_MIN``."""
    return _segment_reduce(vals, ids, n_segments, is_max=True)
