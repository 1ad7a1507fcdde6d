"""Columnar (struct-of-arrays) trace core.

The paper's probes stream ~10^4–10^6 committed instructions per workload;
holding each as a Python :class:`~cimbench.ref.isa.Inst` makes every
downstream stage (IDG construction, candidate selection, energy pricing)
an object-at-a-time walk.  This module stores the committed instruction
queue as one numpy array per I-state field instead:

  ====================  ======================================== =========
  column                meaning (Table I field)                  dtype
  ====================  ======================================== =========
  ``op``                mnemonic code (``isa.OPS``)              int16
  ``unit``              triggered functional unit (``UNITS``)    int8
  ``dtype``             operand class, ``i``/``f``               int8
  ``dst``               destination register (−1 = none)         int32
  ``addr``              memory address (−1 = not a mem access)   int64
  ``size``              access bytes                             int16
  ``level``             serving cache level (``LEVELS``)         int8
  ``hit``               first-level hit (−1 unset / 0 / 1)       int8
  ``bank``              bank id at ``level`` (−1 unset)          int16
  ``mshr``              merged into an in-flight MSHR            bool
  ``src_off/tag/val``   CSR-encoded operand list per instruction
  ====================  ======================================== =========

``seq`` is implicit (the row index).  The structural columns (everything
except ``level``/``hit``/``bank``/``mshr``) depend only on the traced
program — never on the cache geometry — so one structural trace is shared
across every cache configuration of a sweep and only the four
memory-response columns are re-derived per geometry
(:meth:`ColumnarTrace.with_mem_results`, fed by
:meth:`cimbench.ref.cache.CacheHierarchy.replay`).

:class:`ColumnarTrace` is also a ``Sequence[Inst]``: ``trace[seq]``
materializes a plain :class:`~cimbench.ref.isa.Inst` row view on demand
(cached), so tree walks, reports, and hand-written analysis code keep
working unchanged while the hot paths (``core.idg``, ``core.offload``,
``core.profiler``) consume the columns directly.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from cimbench.ref.isa import (DTYPE_TAGS, IMM_BOOL, IMM_FLOAT, IMM_INT, LEVELS,
                            OPS, OP_LOAD, OP_STORE, SRC_IMM, SRC_REG, UNITS,
                            Inst)

_MEM_OPS = (OP_LOAD, OP_STORE)

# ColumnarBuilder bit-packs (op | unit<<5 | dtype<<9 | (dst+1)<<10 |
# size<<18) into one smallint per instruction — fail loudly at import time
# if a vocabulary ever outgrows its field instead of silently corrupting
# every decoded trace.
assert len(OPS) <= 32, "OPS outgrew the 5-bit op field: widen the packing"
assert len(UNITS) <= 16, "UNITS outgrew the 4-bit unit field"
#: largest register id the packed ``dst`` field (8 bits, +1 offset) holds
MAX_REG_ID = 254


def _imm_kind(v) -> int:
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return IMM_BOOL
    if isinstance(v, (int, np.integer)):
        return IMM_INT
    return IMM_FLOAT


def decode_imm(val: float, kind: int):
    """float64 storage -> the Python scalar the emitter recorded."""
    if kind == IMM_INT:
        return int(val)
    if kind == IMM_BOOL:
        return bool(val)
    return float(val)


class ColumnarBuilder:
    """Append-only column accumulator the trace VM emits into.

    One ``add()`` call per committed instruction — a handful of
    plain-scalar list appends, no per-instruction object construction.
    The narrow fields are bit-packed into one Python smallint per
    instruction (and one per operand) at emission time and unpacked
    *vectorized* in ``finish()``:

      ``meta``  =  op | unit<<5 | dtype<<9 | (dst+1)<<10 | size<<18
      ``src``   =  tag | kind<<1   (plus the float64 value list)
    """

    __slots__ = ("n", "meta", "addr", "src_n", "src_meta", "src_val")

    def __init__(self):
        self.n = 0
        self.meta: List[int] = []
        self.addr: List[int] = []
        self.src_n: List[int] = []
        self.src_meta: List[int] = []
        self.src_val: List[float] = []

    def add(self, op: int, unit: int, dt: int, dst: int, addr: int,
            size: int, srcs: Tuple[Tuple[int, object], ...]) -> int:
        """Commit one instruction; returns its sequence index."""
        seq = self.n
        self.n = seq + 1
        self.meta.append(op | unit << 5 | dt << 9 | (dst + 1) << 10
                         | size << 18)
        self.addr.append(addr)
        self.src_n.append(len(srcs))
        meta_l, val_l = self.src_meta, self.src_val
        for tag, val in srcs:
            if tag == SRC_REG:
                meta_l.append(SRC_REG)
                val_l.append(val)
            else:
                t = type(val)
                kind = (IMM_INT if t is int else
                        IMM_FLOAT if t is float else _imm_kind(val))
                meta_l.append(SRC_IMM | kind << 1)
                val_l.append(float(val))
        return seq

    def finish(self, n_regs: int) -> "ColumnarTrace":
        src_off = np.zeros(self.n + 1, np.int64)
        np.cumsum(self.src_n, out=src_off[1:])
        n = self.n
        meta = np.asarray(self.meta, np.int64)
        src_meta = np.asarray(self.src_meta, np.uint8)
        return ColumnarTrace(
            n=n,
            op=(meta & 31).astype(np.int16),
            unit=((meta >> 5) & 15).astype(np.int8),
            dtype=((meta >> 9) & 1).astype(np.int8),
            dst=(((meta >> 10) & 255) - 1).astype(np.int32),
            addr=np.asarray(self.addr, np.int64),
            size=(meta >> 18).astype(np.int16),
            level=np.zeros(n, np.int8),
            hit=np.full(n, -1, np.int8),
            bank=np.full(n, -1, np.int16),
            mshr=np.zeros(n, bool),
            src_off=src_off,
            src_tag=(src_meta & 1),
            src_val=np.asarray(self.src_val, np.float64),
            src_kind=(src_meta >> 1).astype(np.int8),
            n_regs=n_regs,
        )


#: names of the persistable array columns, in a stable order (the on-disk
#: .npz encoding in the analysis store writes exactly these, prefixed "col_")
COLUMNS = ("op", "unit", "dtype", "dst", "addr", "size", "level", "hit",
           "bank", "mshr", "src_off", "src_tag", "src_val", "src_kind")
_STRUCTURAL = tuple(c for c in COLUMNS
                    if c not in ("level", "hit", "bank", "mshr"))


class ColumnarTrace(Sequence):
    """The committed instruction queue as struct-of-arrays (see module doc).

    Sequence protocol: ``len(trace)``, ``trace[seq]`` and iteration yield
    lazily materialized :class:`~cimbench.ref.isa.Inst` row views, so the
    columnar trace is a drop-in replacement for the old ``List[Inst]``.

    ``_struct`` is a memo dictionary *shared between geometry variants* of
    one structural trace (``with_mem_results`` keeps the structural arrays
    and this dict by reference): derived structural artifacts — the
    vectorized RUT/IHT tables, producer indices, flow index, selection
    partitions — are computed once per traced program however many cache
    configurations a sweep prices.
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

    # ------------------------------------------------------- construction
    def with_mem_results(self, level: np.ndarray, hit: np.ndarray,
                         bank: np.ndarray, mshr: np.ndarray
                         ) -> "ColumnarTrace":
        """A geometry variant: same structural columns (by reference, and
        the same ``_struct`` memo), new memory-response columns."""
        return ColumnarTrace(
            self.n, self.op, self.unit, self.dtype, self.dst, self.addr,
            self.size, level, hit, bank, mshr, self.src_off, self.src_tag,
            self.src_val, self.src_kind, self.n_regs,
            struct_cache=self._struct)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Column dict for .npz persistence (the analysis store)."""
        out = {f"col_{name}": getattr(self, name) for name in COLUMNS}
        out["meta_n_regs"] = np.asarray([self.n_regs], np.int64)
        return out

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]) -> "ColumnarTrace":
        cols = {name: arrays[f"col_{name}"] for name in COLUMNS}
        n = len(cols["op"])
        return cls(n=n, n_regs=int(arrays["meta_n_regs"][0]), **cols)

    # ------------------------------------------------------ sequence view
    def __len__(self) -> int:
        return self.n

    def _col_lists(self):
        """Python-list mirrors of the row-relevant columns (lazy, one-time):
        scalar list indexing is ~10x cheaper than numpy scalar indexing
        when materializing many row views."""
        if self._lists is None:
            self._lists = tuple(
                getattr(self, c).tolist()
                for c in ("op", "unit", "dtype", "dst", "addr", "size",
                          "level", "hit", "bank", "mshr", "src_off",
                          "src_tag", "src_val", "src_kind"))
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
        lv = level[seq]
        inst.level = LEVELS[lv]
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
    def mem_mask(self) -> np.ndarray:
        m = self._struct.get("mem_mask")
        if m is None:
            m = self._struct["mem_mask"] = np.isin(self.op, _MEM_OPS)
        return m

    def mem_accesses(self) -> int:
        return int(self.mem_mask.sum())

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, c).nbytes for c in COLUMNS)

    # ------------------------------------------- legacy dict-table views
    # The incremental RUT/IHT of the paper's probes (Fig. 6) are now
    # *derived* tables, reconstructed vectorized in core/idg.py; these
    # properties expose them in the exact dict shapes the object-based
    # pipeline (and hand-written tests) always used.
    @property
    def rut(self) -> Dict[int, List[int]]:
        tables = self._struct.get("rut_iht")
        if tables is None:
            from cimbench.ref.idg import build_rut_iht
            tables = self._struct["rut_iht"] = build_rut_iht(self)
        return tables[0]

    @property
    def iht(self) -> Dict[int, List[Tuple[int, int]]]:
        tables = self._struct.get("rut_iht")
        if tables is None:
            from cimbench.ref.idg import build_rut_iht
            tables = self._struct["rut_iht"] = build_rut_iht(self)
        return tables[1]

    def __repr__(self) -> str:
        return (f"<ColumnarTrace n={self.n} mem={self.mem_accesses()} "
                f"bytes={self.nbytes}>")
