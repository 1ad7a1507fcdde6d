"""Columnar (struct-of-arrays) trace core, as torch tensors on one device.

Twin of ``repro/core/columnar.py``.  The committed instruction queue is
one tensor per I-state field, all on the same ``torch.device``:

  ====================  ======================================== =========
  column                meaning (Table I field)                  dtype
  ====================  ======================================== =========
  ``op``                mnemonic code (``isa.OPS``)              int16
  ``unit``              triggered functional unit (``UNITS``)    int8
  ``dtype``             operand class, ``i``/``f``               int8
  ``dst``               destination register (-1 = none)         int32
  ``addr``              memory address (-1 = not a mem access)   int64
  ``size``              access bytes                             int16
  ``level``             serving cache level (``LEVELS``)         int8
  ``hit``               first-level hit (-1 unset / 0 / 1)       int8
  ``bank``              bank id at ``level`` (-1 unset)          int16
  ``mshr``              merged into an in-flight MSHR            bool
  ``src_off/tag/val``   CSR-encoded operand list per instruction
  ====================  ======================================== =========

The dtypes, and the ``.npz`` layer-1 encoding of :meth:`to_arrays` /
:meth:`from_arrays`, are the reference's exactly: ``from_arrays`` is the
bridge that turns a reference trace into a port trace.  ``src_val`` stays
float64 with a kind tag (:func:`decode_imm`).

The structural columns are shared by every geometry variant of one trace
(:meth:`ColumnarTrace.with_mem_results`), together with the ``_struct``
memo that holds the derived tables (RUT/IHT, flow index, partitions).
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.isa import (DTYPE_TAGS, IMM_BOOL, IMM_INT, LEVELS,
                                  OPS, OP_LOAD, OP_STORE, SRC_IMM, SRC_REG,
                                  UNITS, Inst)

#: names of the persistable columns, in the reference's stable order
COLUMNS = ("op", "unit", "dtype", "dst", "addr", "size", "level", "hit",
           "bank", "mshr", "src_off", "src_tag", "src_val", "src_kind")


def resolve_device(device) -> torch.device:
    """``device`` as a concrete ``torch.device``.

    ``"cuda"`` without a usable card raises instead of quietly running on
    the CPU: every entry point of the port runs where the caller asked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def decode_imm(val: float, kind: int):
    """float64 storage -> the Python scalar the emitter recorded."""
    if kind == IMM_INT:
        return int(val)
    if kind == IMM_BOOL:
        return bool(val)
    return float(val)


class ColumnarTrace(Sequence):
    """The committed instruction queue as struct-of-tensors.

    Sequence protocol: ``len(trace)``, ``trace[seq]`` and iteration yield
    lazily materialized :class:`~repro_torch.core.isa.Inst` row views.

    ``_struct`` is a memo dictionary *shared between geometry variants* of
    one structural trace: derived structural artifacts are computed once
    per traced program however many cache configurations are priced.
    """

    __slots__ = ("n", "op", "unit", "dtype", "dst", "addr", "size", "level",
                 "hit", "bank", "mshr", "src_off", "src_tag", "src_val",
                 "src_kind", "n_regs", "_rows", "_lists", "_struct")

    def __init__(self, n, op, unit, dtype, dst, addr, size, level, hit,
                 bank, mshr, src_off, src_tag, src_val, src_kind,
                 n_regs: int, struct_cache: Optional[dict] = None):
        self.n = int(n)
        self.op = op
        self.unit = unit
        self.dtype = dtype
        self.dst = dst
        self.addr = addr
        self.size = size
        self.level = level
        self.hit = hit
        self.bank = bank
        self.mshr = mshr
        self.src_off = src_off
        self.src_tag = src_tag
        self.src_val = src_val
        self.src_kind = src_kind
        self.n_regs = int(n_regs)
        self._rows: Dict[int, Inst] = {}
        self._lists = None
        self._struct = struct_cache if struct_cache is not None else {}

    @property
    def device(self) -> torch.device:
        return self.op.device

    # ------------------------------------------------------- construction
    def with_mem_results(self, level: torch.Tensor, hit: torch.Tensor,
                         bank: torch.Tensor, mshr: torch.Tensor
                         ) -> "ColumnarTrace":
        """A geometry variant: same structural columns (by reference, and
        the same ``_struct`` memo), new memory-response columns."""
        return ColumnarTrace(
            self.n, self.op, self.unit, self.dtype, self.dst, self.addr,
            self.size, level, hit, bank, mshr, self.src_off, self.src_tag,
            self.src_val, self.src_kind, self.n_regs,
            struct_cache=self._struct)

    def to(self, device) -> "ColumnarTrace":
        """This trace on ``device``: itself when it already lives there
        (keeping its memo), else a copy with a fresh memo."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        cols = {c: getattr(self, c).to(dev) for c in COLUMNS}
        return ColumnarTrace(self.n, n_regs=self.n_regs, **cols)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Column dict in the reference's ``.npz`` layer-1 encoding."""
        out = {f"col_{name}": getattr(self, name).cpu().numpy()
               for name in COLUMNS}
        out["meta_n_regs"] = np.asarray([self.n_regs], np.int64)
        return out

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray],
                    device="cuda") -> "ColumnarTrace":
        """Rebuild a trace from the layer-1 encoding (a reference trace's
        ``to_arrays()`` or a committed fixture) on ``device``."""
        dev = resolve_device(device)
        cols = {name: torch.from_numpy(np.ascontiguousarray(
            arrays[f"col_{name}"])).to(dev) for name in COLUMNS}
        n = len(cols["op"])
        return cls(n=n, n_regs=int(arrays["meta_n_regs"][0]), **cols)

    # ------------------------------------------------------ sequence view
    def __len__(self) -> int:
        return self.n

    def _col_lists(self):
        """Python-list mirrors of the row-relevant columns (lazy, one-time)."""
        if self._lists is None:
            self._lists = tuple(getattr(self, c).tolist() for c in COLUMNS)
        return self._lists

    def row(self, seq: int) -> Inst:
        """Materialize (and cache) the ``Inst`` view of one committed row."""
        inst = self._rows.get(seq)
        if inst is not None:
            return inst
        (op, unit, dt, dst, addr, size, level, hit, bank, mshr,
         src_off, src_tag, src_val, src_kind) = self._col_lists()
        lo, hi = src_off[seq], src_off[seq + 1]
        srcs = tuple(
            (SRC_REG, int(src_val[j])) if src_tag[j] == SRC_REG
            else (SRC_IMM, decode_imm(src_val[j], src_kind[j]))
            for j in range(lo, hi))
        d = dst[seq]
        a = addr[seq]
        inst = Inst(seq, OPS[op[seq]], UNITS[unit[seq]], DTYPE_TAGS[dt[seq]],
                    None if d < 0 else d, srcs,
                    addr=None if a < 0 else a, size=size[seq])
        inst.level = LEVELS[level[seq]]
        h = hit[seq]
        inst.hit = None if h < 0 else bool(h)
        b = bank[seq]
        inst.bank = None if b < 0 else b
        inst.mshr = bool(mshr[seq])
        self._rows[seq] = inst
        return inst

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.row(s) for s in range(*i.indices(self.n))]
        if i < 0:
            i += self.n
        if not 0 <= i < self.n:
            raise IndexError(i)
        return self.row(i)

    def __iter__(self) -> Iterator[Inst]:
        for seq in range(self.n):
            yield self.row(seq)

    # --------------------------------------------------- vectorized views
    @property
    def mem_mask(self) -> torch.Tensor:
        m = self._struct.get("mem_mask")
        if m is None:
            m = self._struct["mem_mask"] = ((self.op == OP_LOAD)
                                            | (self.op == OP_STORE))
        return m

    def mem_accesses(self) -> int:
        return int(self.mem_mask.sum())

    # ------------------------------------------- legacy dict-table views
    @property
    def rut(self) -> Dict[int, List[int]]:
        return self._rut_iht()[0]

    @property
    def iht(self) -> Dict[int, List[Tuple[int, int]]]:
        return self._rut_iht()[1]

    def _rut_iht(self):
        tables = self._struct.get("rut_iht")
        if tables is None:
            from repro_torch.core.idg import build_rut_iht
            tables = self._struct["rut_iht"] = build_rut_iht(self)
        return tables

    def __repr__(self) -> str:
        return (f"<ColumnarTrace n={self.n} mem={self.mem_accesses()} "
                f"device={self.device}>")
