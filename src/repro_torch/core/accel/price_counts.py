"""Pricing's counts on the card: one launch and one readback a design point.

Everything :func:`repro_torch.core.profiler.profile_system` prices a
columnar trace from is an integer count over the trace's ``unit``,
``level`` and ``op`` columns:

  * the functional-unit histogram over all rows, and over the rows the CiM
    run keeps (``host_seqs``);
  * the (level code, is_store) histogram over the rows with ``level > 0``,
    over all rows and over the ``host_seqs`` rows;
  * the rows that are loads or stores (``mem_accesses``);
  * the converted accesses (the selection's load and store seqs) served at
    L1.

A CUDA trace launches ``csrc/price_counts.cu``, which writes them all into
one int64 buffer of :data:`N_OUT` and copies it to pinned host memory
before it synchronises, in one ctypes call.  A CPU trace takes the plain
version, :func:`_plain`: the bincounts, gathers and sums the profiler ran
before the kernel, into the same buffer.  The kernel replaces no TPU
kernel: the reference counts with numpy on the host.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List

import torch

from repro_torch.core.accel import _build, count_launch
from repro_torch.core.isa import (LEVEL_L1, LEVEL_MEM, LEVELS, OP_LOAD,
                                  OP_STORE)

# csrc/price_counts.cu spells these codes out
assert (OP_LOAD, OP_STORE, LEVEL_L1, LEVEL_MEM, len(LEVELS)) == \
    (0, 1, 1, 3, 4), "the ISA's codes moved: update csrc/price_counts.cu"

#: bins of the unit histograms (the trace's 4-bit unit field) and of the
#: (level, is_store) histograms (level * 2 + is_store, levels 0 to MEM)
UNIT_BINS, MEM_BINS = 16, 2 * len(LEVELS)
#: offsets in the buffer: unit histograms of all rows and of the host rows,
#: (level, is_store) histograms likewise, the load and store rows, the
#: converted accesses at L1, and the rows and indices the kernel refused
UNITS_ALL = 0
UNITS_HOST = UNITS_ALL + UNIT_BINS
MEM_ALL = UNITS_HOST + UNIT_BINS
MEM_HOST = MEM_ALL + MEM_BINS
MEM_ROWS = MEM_HOST + MEM_BINS
CONV_L1 = MEM_ROWS + 1
BAD = CONV_L1 + 1
N_OUT = BAD + 1

_SIG = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
_DTYPES = (("unit", torch.int8), ("level", torch.int8), ("op", torch.int16),
           ("host_seqs", torch.int64), ("conv", torch.int64))
# one pinned readback buffer per thread: each thread synchronises before it
# reads its buffer, so no two launches share one
_pinned = threading.local()


def _refuse(what: str) -> None:
    raise ValueError(f"price_counts: {what}")


def _mem_bins(level: torch.Tensor, is_store: torch.Tensor) -> torch.Tensor:
    """(level code, is_write) histogram over the rows with ``level > 0``."""
    mem = level > 0
    combo = level[mem].to(torch.int64) * 2 + is_store[mem].to(torch.int64)
    return torch.bincount(combo, minlength=MEM_BINS)


def _plain(unit: torch.Tensor, level: torch.Tensor, op: torch.Tensor,
           host_seqs: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
    """The plain version: the counts as one int64 tensor of :data:`N_OUT`,
    from bincounts, gathers and sums."""
    n = unit.numel()
    for name, idx in (("host_seqs", host_seqs), ("conv", conv)):
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
            _refuse(f"{name} indexes outside the trace's {n} rows")
    if n and (int(unit.min()) < 0 or int(unit.max()) >= UNIT_BINS):
        _refuse(f"a unit code outside [0, {UNIT_BINS})")
    if n and int(level.max()) > LEVEL_MEM:
        _refuse(f"a level code above {LEVEL_MEM}")
    is_store = op == OP_STORE
    out = torch.zeros(N_OUT, dtype=torch.int64, device=unit.device)
    out[UNITS_ALL:UNITS_HOST] = torch.bincount(unit.to(torch.int64),
                                               minlength=UNIT_BINS)
    out[UNITS_HOST:MEM_ALL] = torch.bincount(
        unit[host_seqs].to(torch.int64), minlength=UNIT_BINS)
    out[MEM_ALL:MEM_HOST] = _mem_bins(level, is_store)
    out[MEM_HOST:MEM_ROWS] = _mem_bins(level[host_seqs], is_store[host_seqs])
    out[MEM_ROWS] = ((op == OP_LOAD) | is_store).sum()
    out[CONV_L1] = (level[conv] == LEVEL_L1).sum()
    return out


def _launch(unit, level, op, host_seqs, conv, host=None) -> torch.Tensor:
    """One launch of the kernel; with ``host`` (pinned, :data:`N_OUT`
    int64) the counts are on the host when this returns."""
    dev = unit.device
    for (name, dtype), t in zip(_DTYPES, (unit, level, op, host_seqs, conv)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise TypeError(f"price_counts: {name} must be a contiguous "
                            f"{dtype} tensor on {dev}, got {t.dtype} on "
                            f"{t.device}")
    n = unit.numel()
    if level.numel() != n or op.numel() != n:
        raise TypeError("price_counts: unit, level and op differ in length")
    out = torch.empty(N_OUT, dtype=torch.int64, device=dev)
    lib, fn = _build.function(_build.CSRC / "price_counts.cu",
                              "price_counts", _SIG)
    rc = fn(unit.data_ptr(), level.data_ptr(), op.data_ptr(), n,
            host_seqs.data_ptr(), host_seqs.numel(), conv.data_ptr(),
            conv.numel(), out.data_ptr(),
            None if host is None else host.data_ptr(),
            torch._C._cuda_getCurrentRawStream(unit.get_device()))
    _build.check(lib, rc, "price_counts launch")
    count_launch("price_counts")
    return out


# lint: numpy-twin(repro_torch.core.accel.price_counts:_plain)
def price_counts(unit: torch.Tensor, level: torch.Tensor, op: torch.Tensor,
                 host_seqs: torch.Tensor, conv: torch.Tensor) -> List[int]:
    """The :data:`N_OUT` counts as a list on the host: on CUDA tensors one
    launch, one copy to pinned memory and one synchronisation; on CPU
    tensors the plain version.  Raises where a unit code, a level code or
    an index lies outside what the trace holds."""
    if unit.device.type == "cuda":
        host = getattr(_pinned, "buf", None)
        if host is None:
            host = _pinned.buf = torch.empty(N_OUT, dtype=torch.int64,
                                             pin_memory=True)
        _launch(unit, level, op, host_seqs, conv, host)
        counts = host.tolist()
        if counts[BAD]:
            _refuse("a unit code, a level code or an index outside the "
                    "trace")
        return counts
    if unit.device.type == "cpu":
        return _plain(unit, level, op, host_seqs, conv).tolist()
    raise ValueError(f"unsupported device {unit.device}")
