"""Bulk CiM ops (paper Table III): CUDA kernel + plain version.

Twin of ``repro/kernels/cim_bitwise.py``.  The reference's Pallas kernels
tile 2-D arrays in (256, 512) blocks for the TPU's VMEM; the port's kernel
(``csrc/cim_bitwise.cu``) is one flat elementwise pass, a 16-byte vector
a thread, so it takes same-shape int32 or uint32 tensors of any shape.
The library, the function with its argument types and the stream getter
are bound once, so a launch is one allocation and one ctypes call.  Add
and sub wrap, as in the reference.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version,
``ref.cim_bitwise_ref`` / ``ref.cim_bitwise_fused_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.accel import _build
from repro_torch.kernels import CSRC, count_launch, ref

_SRC = CSRC / "cim_bitwise.cu"
_OP_CODE = {"and": 0, "or": 1, "xor": 2, "add": 3, "sub": 4}
_DTYPES = (torch.int32, torch.uint32)
_SIG = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _check(*arrays: torch.Tensor, ops=()) -> None:
    x = arrays[0]
    for op in ops:
        if op not in _OP_CODE:
            raise ValueError(f"unknown op {op!r}; expected one of "
                             f"{sorted(_OP_CODE)}")
    for a in arrays:
        if a.shape != x.shape or a.dtype != x.dtype or a.device != x.device:
            got = [(tuple(t.shape), t.dtype, str(t.device)) for t in arrays]
            raise ValueError(f"operands must share shape, dtype and device: "
                             f"{got}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"int32 or uint32 operands expected, got {x.dtype}")


def _launch(arrays, ops, name: str) -> torch.Tensor:
    arrays = [a.contiguous() for a in arrays]
    x = arrays[0]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out                   # nothing to compute: no launch
    z = arrays[2].data_ptr() if len(arrays) > 2 else None
    lib, fn = _build.function(_SRC, "cim_bitwise", _SIG)
    rc = fn(x.data_ptr(), arrays[1].data_ptr(), z, out.data_ptr(),
            x.numel(), _OP_CODE[ops[0]],
            _OP_CODE[ops[1]] if len(ops) > 1 else -1,
            torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(lib, rc, f"{name} launch")
    count_launch(name)
    return out


def _run(arrays, ops, name: str) -> torch.Tensor:
    _check(*arrays, ops=ops)
    dev = arrays[0].device.type
    if dev == "cuda":
        return _launch(arrays, ops, name)
    if dev == "cpu":
        if len(ops) == 1:
            return ref.cim_bitwise_ref(*arrays, op=ops[0])
        return ref.cim_bitwise_fused_ref(*arrays, op1=ops[0], op2=ops[1])
    raise ValueError(f"unsupported device {arrays[0].device}")


def cim_bitwise(x: torch.Tensor, y: torch.Tensor, *,
                op: str = "and") -> torch.Tensor:
    """``x op y`` elementwise, op in and/or/xor/add/sub."""
    return _run((x, y), (op,), "cim_bitwise")


def cim_bitwise_fused(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, *,
                      op1: str = "add", op2: str = "xor") -> torch.Tensor:
    """``(x op1 y) op2 z`` in one pass (the IDG subtree of Fig. 5)."""
    return _run((x, y, z), (op1, op2), "cim_bitwise_fused")
