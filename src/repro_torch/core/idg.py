"""Instruction Dependency Graph tables -- the paper's Algorithm 2 (Fig. 6).

Twin of ``repro/core/idg.py``.  An IDG is a forest of *flipped trees*:
the root of each tree is a CiM-supported OP instruction, edges point from
an instruction to the instructions that produced its source operands, and
leaves are loads or immediates.  Producers of register operands are found
with the two tables the paper's probes build at commit time:

  RUT (register usage table)   reg -> [seq of instructions that wrote reg]
  IHT (index hash table)       seq -> [(src reg, RUT position at commit)]

Over a :class:`~repro_torch.core.columnar.ColumnarTrace` both tables, and
the producer of every register operand, are rebuilt with tensor ops on the
trace's device (:class:`_StructTables`): a write at ``w`` produces the
operand read at ``s`` iff it is the latest write to that register before
``s``.  The reference runs one ``searchsorted`` per register; here one
``searchsorted`` over a (register, seq) key covers all registers at once.

:class:`FlowIndex` keeps the reference's CSR layout, as tensors.

:class:`IDGBuilder` resolves producers and builds :class:`IDGNode` trees
over both trace kinds.  On a columnar trace a tree walk reads the host
mirrors that exist once per trace (``ColumnarTrace._col_lists`` and the
``_StructTables`` lists), never a device tensor per node.  A hand-built
``List[Inst]`` trace (tests, exploration) is a host object, with explicit
RUT/IHT dict tables: its builder and :func:`_build_flow_rows` run on the
host, as the reference's do, and its flow tables are CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.columnar import (COLUMNS, ColumnarTrace, decode_imm,
                                       resolve_device)
from repro_torch.core.isa import OP_CODE, OP_STORE, SRC_IMM, SRC_REG, Inst

# leaf kinds
LEAF_LOAD = "load"            # Algorithm 2's LEAF_TRUE
LEAF_IMM = "imm"              # Fig. 4(b) variant
LEAF_MEMVAL = "memval"        # value produced by a non-CiM op, resident in
                              # memory via its store (Fig. 4(c) boundary)

_I64 = torch.int64
# positions of the operand columns in ``ColumnarTrace._col_lists()``
_SRC_TAG, _SRC_VAL, _SRC_KIND = (COLUMNS.index(c) for c in
                                 ("src_tag", "src_val", "src_kind"))


@dataclasses.dataclass
class IDGNode:
    """One node of an IDG tree.  ``children`` holds (kind, payload) where
    payload is an Inst for load leaves / op nodes, or the immediate value."""
    inst: Inst
    children: List[Tuple[str, object]] = dataclasses.field(default_factory=list)

    @property
    def left(self):          # the paper's binary view (Algorithm 2)
        return self.children[0] if self.children else None

    @property
    def right(self):
        return self.children[1] if len(self.children) > 1 else None

    def iter_nodes(self) -> Iterator["IDGNode"]:
        yield self
        for kind, payload in self.children:
            if kind == "node":
                yield from payload.iter_nodes()

    def load_leaves(self) -> List[Inst]:
        out = []
        for kind, payload in self.children:
            if kind == LEAF_LOAD:
                out.append(payload)
            elif kind == "node":
                out.extend(payload.load_leaves())
        return out

    def size_ops(self) -> int:
        return sum(1 for _ in self.iter_nodes())


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
# Builder: resolves producers and builds trees (both trace layouts)
# ======================================================================
class IDGBuilder:
    """Resolves producers over a trace and builds IDG trees.

    Columnar traces resolve producers through the vectorized producer
    index, read through its host mirrors (lazy ``Inst`` row views from
    ``ColumnarTrace.row``); hand-built ``List[Inst]`` traces use the
    classic (RUT, IHT) dict tables, on the host."""

    def __init__(self, trace, rut: Optional[Dict[int, List[int]]] = None,
                 iht: Optional[Dict[int, List[Tuple[int, int]]]] = None):
        self.trace = trace
        self._fast = isinstance(trace, ColumnarTrace)
        if not self._fast and (rut is None or iht is None):
            raise ValueError("list-of-Inst traces need explicit RUT/IHT "
                             "tables (trace_program builds them)")
        self.rut = rut
        self.iht = iht

    # ------------------------------------------------------------ lookups
    def producer_of(self, seq: int, src_slot: int) -> Optional[Inst]:
        """Defining instruction of the ``src_slot``-th *register* source."""
        if self._fast:
            t = _tables(self.trace)
            src_tag = self.trace._col_lists()[_SRC_TAG]
            slot = 0
            for j in range(t.src_off_l[seq], t.src_off_l[seq + 1]):
                if src_tag[j] != SRC_REG:
                    continue
                if slot == src_slot:
                    prod = t.full_prod_l[j]
                    return self.trace.row(prod) if prod >= 0 else None
                slot += 1
            return None
        entries = self.iht.get(seq, ())
        if src_slot >= len(entries):
            return None
        reg, pos = entries[src_slot]
        writes = self.rut.get(reg, ())
        if 0 <= pos < len(writes):
            return self.trace[writes[pos]]
        return None

    def producers(self, inst: Inst) -> List[Tuple[str, object]]:
        """All source operands of ``inst`` resolved to (kind, payload).

        kind: "imm" for immediates, "inst" for register operands (payload =
        producing Inst), "unknown" when the register has no recorded writer
        (pre-existing machine state).
        """
        if self._fast:
            return self._producers_seq(inst.seq)
        out: List[Tuple[str, object]] = []
        reg_slot = 0
        for tag, val in inst.srcs:
            if tag == SRC_IMM:
                out.append(("imm", val))
            else:
                p = self.producer_of(inst.seq, reg_slot)
                reg_slot += 1
                out.append(("inst", p) if p is not None else ("unknown", val))
        return out

    def _producers_seq(self, seq: int) -> List[Tuple[str, object]]:
        t = _tables(self.trace)
        row = self.trace.row
        cols = self.trace._col_lists()
        tag, val, kind, prod = (cols[_SRC_TAG], cols[_SRC_VAL],
                                cols[_SRC_KIND], t.full_prod_l)
        out: List[Tuple[str, object]] = []
        for j in range(t.src_off_l[seq], t.src_off_l[seq + 1]):
            if tag[j] == SRC_IMM:
                out.append(("imm", decode_imm(val[j], kind[j])))
            else:
                p = prod[j]
                out.append(("inst", row(p)) if p >= 0
                           else ("unknown", int(val[j])))
        return out

    # ------------------------------------------------------- tree building
    def create_tree(self, root: Inst, cim_set: FrozenSet[str],
                    claimed: Optional[set] = None,
                    max_ops: int = 64) -> Optional[IDGNode]:
        """Algorithm 2's create_tree: recursive producer expansion.

        Recurses through CiM-supported producers (composite patterns),
        terminates at load leaves / immediates, and cuts at non-CiM
        producers (their value is memory-resident via its store ->
        LEAF_MEMVAL).  ``claimed`` marks instructions already owned by an
        accepted candidate -- the partition step's bookkeeping.
        """
        if root.op not in cim_set:
            return None
        budget = [max_ops]

        def build(inst: Inst) -> Optional[IDGNode]:
            if budget[0] <= 0:
                return None
            budget[0] -= 1
            node = IDGNode(inst)
            for kind, payload in self.producers(inst):
                if kind == "imm":
                    node.children.append((LEAF_IMM, payload))
                elif kind == "unknown":
                    node.children.append((LEAF_IMM, payload))
                else:
                    p: Inst = payload
                    if p.is_load:
                        node.children.append((LEAF_LOAD, p))
                    elif p.op == "mov" and all(t == SRC_IMM for t, _ in p.srcs):
                        # accumulator init (mov #imm): an immediate leaf
                        node.children.append((LEAF_IMM, p.srcs[0][1]))
                    elif (p.op in cim_set
                          and (claimed is None or p.seq not in claimed)):
                        sub = build(p)
                        if sub is None:
                            node.children.append((LEAF_MEMVAL, p))
                        else:
                            node.children.append(("node", sub))
                    else:
                        node.children.append((LEAF_MEMVAL, p))
            return node

        return build(root)

    def cim_root_seqs(self, cim_set: FrozenSet[str]) -> torch.Tensor:
        """Ascending seqs of every CiM-supported instruction (columnar
        traces), on the trace's device."""
        codes = torch.tensor(sorted(OP_CODE[o] for o in cim_set
                                    if o in OP_CODE),
                             dtype=self.trace.op.dtype,
                             device=self.trace.device)
        return torch.nonzero(torch.isin(self.trace.op, codes)).flatten()

    def build_forest(self, cim_set: FrozenSet[str],
                     max_ops: int = 64) -> List[IDGNode]:
        """Algorithm 2's outer loop: one tree per CiM-supported instruction.

        (Offload selection uses a claimed-set variant instead so composite
        candidates are extracted exactly once -- see core/offload.py.)
        """
        if self._fast:
            roots = [self.trace.row(seq) for seq in
                     self.cim_root_seqs(cim_set).tolist()]
        else:
            roots = [inst for inst in self.trace if inst.op in cim_set]
        forest = []
        for inst in roots:
            tree = self.create_tree(inst, cim_set, max_ops=max_ops)
            if tree is not None:
                forest.append(tree)
        return forest


# ======================================================================
# Auxiliary producer/consumer indices used by selection + reshaping
# ======================================================================
#: the CSR / paired-array tables of a :class:`FlowIndex`, in the reference's
#: ``to_arrays`` order
_FLOW_TABLES = ("rc_off", "rc_val", "so_off", "so_val", "ls_seq", "ls_src")


class FlowIndex:
    """Derived O(N) flow maps over a trace (built once, reused everywhere).

    Columnar storage -- CSR/paired-array tensors on the trace's device --
    with lazy list mirrors for the host-side selection walk, and the
    reference's dict views as lazy properties:

      ``consumers_of(seq)``    register consumers of an op's value
      ``stores_of(seq)``       stores that spilled an op's value
      ``load_source_of(seq)``  producing op behind a load (-1: none)
    """

    __slots__ = ("n", "rc_off", "rc_val", "so_off", "so_val", "ls_seq",
                 "ls_src", "_py", "_dicts")

    def __init__(self, n: int, rc_off, rc_val, so_off, so_val,
                 ls_seq, ls_src, dicts: Optional[dict] = None):
        self.n = n
        self.rc_off = rc_off
        self.rc_val = rc_val
        self.so_off = so_off
        self.so_val = so_val
        self.ls_seq = ls_seq
        self.ls_src = ls_src
        self._py = None
        self._dicts = dicts

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

    # ------------------------------------------------------- dict views
    def _build_dicts(self) -> dict:
        if self._dicts is None:
            rc_off, rc_val, so_off, so_val, _ = self._py_tables()

            def csr_dict(offs, vals):
                return {seq: vals[offs[seq]:offs[seq + 1]]
                        for seq in range(self.n)
                        if offs[seq + 1] > offs[seq]}

            load_source = {}
            value_loads: Dict[int, List[int]] = {}
            for s, src in zip(self.ls_seq.tolist(), self.ls_src.tolist()):
                load_source[s] = None if src < 0 else src
                if src >= 0:
                    value_loads.setdefault(src, []).append(s)
            self._dicts = {
                "reg_consumers": csr_dict(rc_off, rc_val),
                "store_of": csr_dict(so_off, so_val),
                "load_source": load_source,
                "value_loads": value_loads,
            }
        return self._dicts

    @property
    def reg_consumers(self) -> Dict[int, List[int]]:
        return self._build_dicts()["reg_consumers"]

    @property
    def store_of(self) -> Dict[int, List[int]]:
        return self._build_dicts()["store_of"]

    @property
    def load_source(self) -> Dict[int, Optional[int]]:
        return self._build_dicts()["load_source"]

    @property
    def value_loads(self) -> Dict[int, List[int]]:
        return self._build_dicts()["value_loads"]

    # -------------------------------------------------------- construction
    @classmethod
    def from_dicts(cls, reg_consumers, store_of, load_source, value_loads,
                   n: int) -> "FlowIndex":
        """Wrap dict tables built by the row-path construction (CPU
        tensors: a row trace is a host object)."""
        def dict_csr(d):
            counts = [0] * n
            for k, v in d.items():
                counts[k] = len(v)
            off = torch.zeros(n + 1, dtype=_I64)
            torch.cumsum(torch.tensor(counts, dtype=_I64), 0, out=off[1:])
            vals = [x for k in sorted(d) for x in d[k]]
            return off, torch.tensor(vals, dtype=_I64)

        rc_off, rc_val = dict_csr(reg_consumers)
        so_off, so_val = dict_csr(store_of)
        ls_seq = sorted(load_source)
        ls_src = [-1 if load_source[s] is None else load_source[s]
                  for s in ls_seq]
        return cls(n, rc_off, rc_val, so_off, so_val,
                   torch.tensor(ls_seq, dtype=_I64),
                   torch.tensor(ls_src, dtype=_I64),
                   dicts={"reg_consumers": reg_consumers,
                          "store_of": store_of,
                          "load_source": load_source,
                          "value_loads": value_loads})

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
        self._dicts = None


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


def _build_flow_rows(trace: List[Inst], rut, iht) -> FlowIndex:
    """The object-at-a-time construction (hand-built traces, on the
    host)."""
    b = IDGBuilder(trace, rut, iht)
    reg_consumers: Dict[int, List[int]] = {}
    store_of: Dict[int, List[int]] = {}
    load_source: Dict[int, Optional[int]] = {}
    value_loads: Dict[int, List[int]] = {}
    last_writer_of_addr: Dict[int, int] = {}      # addr -> producing op seq

    for inst in trace:
        for kind, payload in b.producers(inst):
            if kind == "inst":
                p: Inst = payload
                reg_consumers.setdefault(p.seq, []).append(inst.seq)
                if inst.is_store:
                    store_of.setdefault(p.seq, []).append(inst.seq)
        if inst.is_store:
            prods = [p.seq for k, p in b.producers(inst) if k == "inst"]
            if prods:
                last_writer_of_addr[inst.addr] = prods[0]
        elif inst.is_load:
            src = last_writer_of_addr.get(inst.addr)
            load_source[inst.seq] = src
            if src is not None:
                value_loads.setdefault(src, []).append(inst.seq)
    return FlowIndex.from_dicts(reg_consumers, store_of, load_source,
                                value_loads, len(trace))


def build_flow_index(trace, rut=None, iht=None) -> FlowIndex:
    """Flow tables for a trace -- vectorized on the trace's device for
    columnar traces (cached on the structural trace, so every geometry
    variant shares one build), object-at-a-time on the host for hand-built
    ``List[Inst]`` traces."""
    if isinstance(trace, ColumnarTrace):
        flow = trace._struct.get("flow")
        if flow is None:
            flow = trace._struct["flow"] = _build_flow_columnar(trace)
        return flow
    return _build_flow_rows(trace, rut, iht)
