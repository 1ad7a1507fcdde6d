"""Instruction Dependency Graph tables -- the paper's Algorithm 2 (Fig. 6).

Twin of ``repro/core/idg.py``, columnar half.  Producers of register
operands are found with the two tables the paper's probes build at commit
time:

  RUT (register usage table)   reg -> [seq of instructions that wrote reg]
  IHT (index hash table)       seq -> [(src reg, RUT position at commit)]

Over a :class:`~repro_torch.core.columnar.ColumnarTrace` both tables, and
the producer of every register operand, are rebuilt with tensor ops on the
trace's device (:class:`_StructTables`): a write at ``w`` produces the
operand read at ``s`` iff it is the latest write to that register before
``s``.  The reference runs one ``searchsorted`` per register; here one
``searchsorted`` over a (register, seq) key covers all registers at once.

:class:`FlowIndex` keeps the reference's CSR layout, as tensors.  The
hand-built ``List[Inst]`` path (``IDGNode`` trees, ``_build_flow_rows``)
belongs to a later slice.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Tuple

import numpy as np
import torch

from repro_torch.core.columnar import ColumnarTrace, resolve_device
from repro_torch.core.isa import OP_CODE, OP_STORE, SRC_REG

# leaf kinds
LEAF_LOAD = "load"            # Algorithm 2's LEAF_TRUE
LEAF_MEMVAL = "memval"        # value produced by a non-CiM op, resident in
                              # memory via its store (Fig. 4(c) boundary)

_I64 = torch.int64


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """CSR offsets (length ``len(counts) + 1``) from per-row counts."""
    off = torch.zeros(len(counts) + 1, dtype=_I64, device=counts.device)
    torch.cumsum(counts, 0, out=off[1:])
    return off


def _unique_first(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``np.unique(x, return_index=True)``: sorted unique values and the
    index of each one's first occurrence (a stable sort keeps it first)."""
    xs, order = torch.sort(x, stable=True)
    head = torch.ones_like(xs, dtype=torch.bool)
    head[1:] = xs[1:] != xs[:-1]
    return xs[head], order[head]


# ======================================================================
# Vectorized structural tables (columnar traces)
# ======================================================================
class _StructTables:
    """Derived structural indices of one columnar trace (built once, shared
    across every geometry variant via the trace's ``_struct`` memo).

    Register-source entries are the sub-sequence of the source-operand CSR
    with ``tag == SRC_REG``, in global (seq-major, slot-order) order:

      ``ent_seq``   consumer instruction of each entry
      ``ent_reg``   register read
      ``ent_pos``   the IHT position (writes-before-count - 1)
      ``ent_prod``  producing instruction (-1: no prior write)
      ``ireg_off``  CSR offsets per instruction into the entry arrays

    ``full_prod`` aligns with the *full* source CSR (immediates -> -2) so
    producer resolution during a tree walk is one list index.
    """

    __slots__ = ("ent_seq", "ent_reg", "ent_pos", "ent_prod", "ireg_off",
                 "full_prod", "w_off", "w_seq", "full_prod_l", "src_off_l")

    def __init__(self, ct: ColumnarTrace):
        n = ct.n
        dev = ct.device
        n_slots = ct.n_regs + 1                       # + induction register
        counts = ct.src_off[1:] - ct.src_off[:-1]
        seq_of_entry = torch.repeat_interleave(
            torch.arange(n, dtype=_I64, device=dev), counts)
        ent_idx = torch.nonzero(ct.src_tag == SRC_REG).flatten()
        self.ent_seq = seq_of_entry[ent_idx]
        self.ent_reg = ct.src_val[ent_idx].to(_I64)
        # per-instruction CSR over the entry arrays
        self.ireg_off = _offsets(torch.bincount(self.ent_seq, minlength=n))
        # writer lists per register (the RUT), register-major / seq-ascending
        wr_idx = torch.nonzero(ct.dst >= 0).flatten()
        wr_reg = ct.dst[wr_idx].to(_I64)
        wr_reg_sorted, order = torch.sort(wr_reg, stable=True)
        self.w_seq = wr_idx[order]
        self.w_off = _offsets(torch.bincount(wr_reg, minlength=n_slots))
        # producer of each register-source entry: the latest write to its
        # register before it.  Keys (reg, seq) -> reg * (n + 1) + seq sort
        # the writes exactly as they are stored, so one left searchsorted
        # gives lo(reg) + (writes to reg before seq).
        self.ent_pos = torch.full_like(self.ent_seq, -1)
        self.ent_prod = torch.full_like(self.ent_seq, -1)
        if len(self.w_seq) and len(ent_idx):
            stride = n + 1
            idx = torch.searchsorted(wr_reg_sorted * stride + self.w_seq,
                                     self.ent_reg * stride + self.ent_seq)
            known = (self.ent_reg >= 0) & (self.ent_reg < n_slots)
            lo = self.w_off[self.ent_reg.clamp(0, n_slots - 1)]
            pos = torch.where(known, idx - lo - 1, -1)
            self.ent_pos = pos
            self.ent_prod = torch.where(
                pos >= 0, self.w_seq[(idx - 1).clamp(min=0)], -1)
        self.full_prod = torch.full((len(ct.src_tag),), -2, dtype=_I64,
                                    device=dev)
        self.full_prod[ent_idx] = self.ent_prod
        # python-list mirrors for the (scalar-at-a-time) tree walks
        self.full_prod_l = self.full_prod.tolist()
        self.src_off_l = ct.src_off.tolist()


def _tables(ct: ColumnarTrace) -> _StructTables:
    t = ct._struct.get("tables")
    if t is None:
        t = ct._struct["tables"] = _StructTables(ct)
    return t


def build_rut_iht(ct: ColumnarTrace
                  ) -> Tuple[Dict[int, List[int]],
                             Dict[int, List[Tuple[int, int]]]]:
    """Reconstruct the probe-style RUT/IHT dicts from the columns.

    RUT has one (possibly empty) entry per architectural register, IHT one
    entry per committed instruction listing its register sources with
    their RUT position at commit time."""
    t = _tables(ct)
    w_seq = t.w_seq.tolist()
    w_off = t.w_off.tolist()
    rut: Dict[int, List[int]] = {}
    for r in range(ct.n_regs + 1):
        rut[r] = w_seq[w_off[r]:w_off[r + 1]]
    ent_reg = t.ent_reg.tolist()
    ent_pos = t.ent_pos.tolist()
    off = t.ireg_off.tolist()
    iht: Dict[int, List[Tuple[int, int]]] = {}
    for seq in range(ct.n):
        iht[seq] = [(ent_reg[j], ent_pos[j])
                    for j in range(off[seq], off[seq + 1])]
    return rut, iht


# ======================================================================
# Builder: the columnar half (CiM roots)
# ======================================================================
class IDGBuilder:
    """Producer resolution over a columnar trace.

    The selection path needs only the CiM roots here (trees are walked over
    raw sequence indices in :mod:`repro_torch.core.offload`); ``Inst``-tree
    construction for row traces belongs to a later slice."""

    def __init__(self, trace: ColumnarTrace):
        if not isinstance(trace, ColumnarTrace):
            raise NotImplementedError(
                "IDGBuilder over List[Inst] traces is not ported yet "
                "(ROADMAP Queue 1: single-pass Algorithm 1 and row traces)")
        self.trace = trace

    def cim_root_seqs(self, cim_set: FrozenSet[str]) -> torch.Tensor:
        """Ascending seqs of every CiM-supported instruction."""
        codes = torch.tensor(sorted(OP_CODE[o] for o in cim_set
                                    if o in OP_CODE),
                             dtype=self.trace.op.dtype,
                             device=self.trace.device)
        return torch.nonzero(torch.isin(self.trace.op, codes)).flatten()


# ======================================================================
# Auxiliary producer/consumer indices used by selection + reshaping
# ======================================================================
#: the CSR / paired-array tables of a :class:`FlowIndex`, in the reference's
#: ``to_arrays`` order
_FLOW_TABLES = ("rc_off", "rc_val", "so_off", "so_val", "ls_seq", "ls_src")


class FlowIndex:
    """Derived O(N) flow maps over a trace (built once, reused everywhere).

    Columnar storage -- CSR/paired-array tensors on the trace's device --
    with lazy list mirrors for the host-side selection walk:

      ``consumers_of(seq)``    register consumers of an op's value
      ``stores_of(seq)``       stores that spilled an op's value
      ``load_source_of(seq)``  producing op behind a load (-1: none)
    """

    __slots__ = ("n", "rc_off", "rc_val", "so_off", "so_val", "ls_seq",
                 "ls_src", "_py")

    def __init__(self, n: int, rc_off, rc_val, so_off, so_val,
                 ls_seq, ls_src):
        self.n = n
        self.rc_off = rc_off
        self.rc_val = rc_val
        self.so_off = so_off
        self.so_val = so_val
        self.ls_seq = ls_seq
        self.ls_src = ls_src
        self._py = None

    # ------------------------------------------------------ fast accessors
    def _py_tables(self):
        """Plain-list mirrors of the CSR tables (lazy, one-time): the
        selection inner loop does tens of thousands of point lookups."""
        if self._py is None:
            full = torch.full((self.n,), -1, dtype=_I64,
                              device=self.ls_seq.device)
            full[self.ls_seq] = self.ls_src
            self._py = (self.rc_off.tolist(), self.rc_val.tolist(),
                        self.so_off.tolist(), self.so_val.tolist(),
                        full.tolist())
        return self._py

    def consumers_of(self, seq: int) -> List[int]:
        rc_off, rc_val, _, _, _ = self._py_tables()
        return rc_val[rc_off[seq]:rc_off[seq + 1]]

    def stores_of(self, seq: int) -> List[int]:
        _, _, so_off, so_val, _ = self._py_tables()
        return so_val[so_off[seq]:so_off[seq + 1]]

    def load_source_of(self, seq: int) -> int:
        return self._py_tables()[4][seq]

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Array dict in the reference's layer-1 encoding."""
        out = {"flow_n": np.asarray([self.n], np.int64)}
        for name in _FLOW_TABLES:
            out[f"flow_{name}"] = getattr(self, name).cpu().numpy()
        return out

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray],
                    device="cuda") -> "FlowIndex":
        """Inverse of :meth:`to_arrays`, the tables on ``device``."""
        dev = resolve_device(device)
        return cls(int(arrays["flow_n"][0]),
                   *(torch.from_numpy(np.ascontiguousarray(
                       arrays[f"flow_{name}"])).to(dev)
                     for name in _FLOW_TABLES))

    def to(self, device) -> "FlowIndex":
        """These tables on ``device`` (itself when they already are)."""
        dev = resolve_device(device)
        if dev == self.rc_off.device:
            return self
        return FlowIndex(self.n, *(getattr(self, name).to(dev)
                                   for name in _FLOW_TABLES))

    # ---------------------------------------------------------- pickling
    # the tables pickle as numpy arrays and come back as CPU tensors, so a
    # pickle never holds a CUDA tensor; :meth:`to` places them
    def __getstate__(self):
        return (self.n, *(getattr(self, name).cpu().numpy()
                          for name in _FLOW_TABLES))

    def __setstate__(self, state):
        self.n = state[0]
        for name, arr in zip(_FLOW_TABLES, state[1:]):
            setattr(self, name, torch.from_numpy(arr))
        self._py = None


def _build_flow_columnar(ct: ColumnarTrace) -> FlowIndex:
    """Vectorized flow construction over the structural columns."""
    t = _tables(ct)
    n = ct.n
    dev = ct.device
    valid = t.ent_prod >= 0
    prod_v = t.ent_prod[valid]
    cons_v = t.ent_seq[valid]

    def group_csr(prods, vals):
        order = torch.sort(prods, stable=True).indices
        off = _offsets(torch.bincount(prods, minlength=n))
        return off, vals[order]

    rc_off, rc_val = group_csr(prod_v, cons_v)
    cons_is_store = ct.op[cons_v] == OP_STORE
    so_off, so_val = group_csr(prod_v[cons_is_store], cons_v[cons_is_store])

    # --- memory flow: each load's producing op via the last store to its
    # address with a resolvable producer (stores without one leave the
    # previous mapping intact, exactly like the incremental construction)
    mem_idx = torch.nonzero(ct.mem_mask).flatten()
    m = len(mem_idx)
    if m == 0:
        empty = torch.zeros(0, dtype=_I64, device=dev)
        return FlowIndex(n, rc_off, rc_val, so_off, so_val, empty, empty)
    ev_is_store = ct.op[mem_idx] == OP_STORE
    # first resolved producer per store instruction
    ev_prod = torch.full((m,), -1, dtype=_I64, device=dev)
    if len(cons_v):
        s_seq = cons_v[cons_is_store]
        s_prod = prod_v[cons_is_store]
        uniq, first = _unique_first(s_seq)
        if len(uniq):
            pos = torch.searchsorted(uniq, mem_idx)
            ok = pos < len(uniq)
            ok &= uniq[pos.clamp(max=len(uniq) - 1)] == mem_idx
            ev_prod[ok] = s_prod[first[pos[ok]]]
    participate = ev_prod >= 0                       # producer-carrying stores

    a_sorted, order = torch.sort(ct.addr[mem_idx], stable=True)  # addr-major
    new_grp = torch.ones(m, dtype=torch.bool, device=dev)
    new_grp[1:] = a_sorted[1:] != a_sorted[:-1]
    gid = torch.cumsum(new_grp, 0) - 1
    # segmented running "last participating store": offset the positions by
    # group so the cummax can never leak across address groups
    v = torch.where(participate[order],
                    torch.arange(m, dtype=_I64, device=dev), -1)
    base = gid * (m + 1)
    w = torch.where(v >= 0, v + base, base - 1)
    res = torch.cummax(w, 0).values - base
    last = torch.where(res >= 0, res, -1)

    load_pos = torch.nonzero(~ev_is_store[order]).flatten()
    last_l = last[load_pos]
    lsrc = torch.where(last_l >= 0, ev_prod[order[last_l.clamp(min=0)]], -1)
    load_seqs = mem_idx[order[load_pos]]
    load_seqs, o2 = torch.sort(load_seqs)
    return FlowIndex(n, rc_off, rc_val, so_off, so_val, load_seqs, lsrc[o2])


def build_flow_index(trace: ColumnarTrace) -> FlowIndex:
    """Flow tables for a columnar trace, cached on the structural trace so
    every geometry variant shares one build."""
    if not isinstance(trace, ColumnarTrace):
        raise NotImplementedError(
            "flow index over List[Inst] traces is not ported yet "
            "(ROADMAP Queue 1: single-pass Algorithm 1 and row traces)")
    flow = trace._struct.get("flow")
    if flow is None:
        flow = trace._struct["flow"] = _build_flow_columnar(trace)
    return flow
