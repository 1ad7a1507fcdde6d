"""Instruction Dependency Graph — the paper's Algorithm 2 (Fig. 6).

An IDG is a forest of *flipped trees*: the root of each tree is a
CiM-supported OP instruction, edges point from an instruction to the
instructions that produced its source operands, and leaves are loads or
immediates.  Construction is O(N) because producers are found with two
tables derived from the committed stream:

  RUT (register usage table)   reg -> [seq of instructions that wrote reg]
  IHT (index hash table)       seq -> [(src reg, RUT position at commit)]

The paper's probes build RUT/IHT incrementally at commit time; over a
columnar trace (:class:`cimbench.ref.columnar.ColumnarTrace`) both tables —
and the producer of every register operand — are reconstructed *vectorized*
from the ``dst`` and source-operand columns (:func:`build_rut_iht`,
:func:`build_flow_index`): a write at sequence ``w`` produces the operand
read at ``s`` iff it is the latest write to that register before ``s``,
which is one ``searchsorted`` per register over the sorted write lists.
The :class:`IDGBuilder` then resolves producers with O(1) array lookups;
:class:`Inst` rows are materialized lazily only for the nodes an actual
tree walk touches.  Hand-built ``List[Inst]`` traces (tests, exploration)
keep the original dict-table path — both paths produce identical forests
(property-tested in ``tests/test_columnar.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

import numpy as np

from cimbench.ref.columnar import ColumnarTrace, decode_imm
from cimbench.ref.isa import (OP_CODE, OP_LOAD, OP_STORE, SRC_IMM, SRC_REG,
                            Inst, Trace)

# leaf kinds
LEAF_LOAD = "load"            # Algorithm 2's LEAF_TRUE
LEAF_IMM = "imm"              # Fig. 4(b) variant
LEAF_MEMVAL = "memval"        # value produced by a non-CiM op, resident in
                              # memory via its store (Fig. 4(c) boundary)


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
      ``ent_pos``   the IHT position (writes-before-count − 1)
      ``ent_prod``  producing instruction (−1: no prior write)
      ``ireg_off``  CSR offsets per instruction into the entry arrays

    ``full_prod`` aligns with the *full* source CSR (immediates → −2) so
    producer resolution during a tree walk is one list index.
    """

    __slots__ = ("ent_seq", "ent_reg", "ent_pos", "ent_prod", "ireg_off",
                 "full_prod", "w_off", "w_seq", "full_prod_l", "src_off_l")

    def __init__(self, ct: ColumnarTrace):
        n = ct.n
        n_slots = ct.n_regs + 1                       # + induction register
        counts = np.diff(ct.src_off)
        seq_of_entry = np.repeat(np.arange(n, dtype=np.int64), counts)
        reg_mask = ct.src_tag == SRC_REG
        ent_idx = np.flatnonzero(reg_mask)
        self.ent_seq = seq_of_entry[ent_idx]
        self.ent_reg = ct.src_val[ent_idx].astype(np.int64)
        # per-instruction CSR over the entry arrays
        per_inst = np.bincount(self.ent_seq, minlength=n) if len(ent_idx) \
            else np.zeros(n, np.int64)
        self.ireg_off = np.zeros(n + 1, np.int64)
        np.cumsum(per_inst, out=self.ireg_off[1:])
        # writer lists per register (the RUT), register-major / seq-ascending
        wr_idx = np.flatnonzero(ct.dst >= 0)
        wr_reg = ct.dst[wr_idx].astype(np.int64)
        order = np.argsort(wr_reg, kind="stable")
        self.w_seq = wr_idx[order]
        self.w_off = np.zeros(n_slots + 1, np.int64)
        np.cumsum(np.bincount(wr_reg, minlength=n_slots),
                  out=self.w_off[1:])
        # producer of each register-source entry: latest write before it
        self.ent_pos = np.full(len(ent_idx), -1, np.int64)
        self.ent_prod = np.full(len(ent_idx), -1, np.int64)
        for r in range(n_slots):
            lo, hi = self.w_off[r], self.w_off[r + 1]
            sel = np.flatnonzero(self.ent_reg == r)
            if not len(sel):
                continue
            if lo == hi:                              # read, never written
                continue
            writes = self.w_seq[lo:hi]
            pos = np.searchsorted(writes, self.ent_seq[sel], side="left") - 1
            self.ent_pos[sel] = pos
            hit = pos >= 0
            self.ent_prod[sel[hit]] = writes[pos[hit]]
        self.full_prod = np.full(len(ct.src_tag), -2, np.int64)
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

    Exactly the tables the old incremental ``Machine._commit`` built: RUT
    has one (possibly empty) entry per architectural register, IHT one
    entry per committed instruction listing its register sources with
    their RUT position at commit time."""
    t = _tables(ct)
    rut: Dict[int, List[int]] = {}
    for r in range(ct.n_regs + 1):
        rut[r] = t.w_seq[t.w_off[r]:t.w_off[r + 1]].tolist()
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

    Columnar traces use the vectorized producer index (O(1) lookups, lazy
    ``Inst`` row views); hand-built ``List[Inst]`` traces use the classic
    (RUT, IHT) dict tables."""

    def __init__(self, trace: Trace,
                 rut: Optional[Dict[int, List[int]]] = None,
                 iht: Optional[Dict[int, List[Tuple[int, int]]]] = None):
        self.trace = trace
        self._fast = isinstance(trace, ColumnarTrace)
        if self._fast:
            self._t = _tables(trace)
            self._src_tag = trace.src_tag.tolist()
            self._src_val = trace.src_val.tolist()
            self._src_kind = trace.src_kind.tolist()
        else:
            if rut is None or iht is None:
                raise ValueError("list-of-Inst traces need explicit RUT/IHT "
                                 "tables (trace_program builds them)")
        self.rut = rut
        self.iht = iht

    # ------------------------------------------------------------ lookups
    def producer_of(self, seq: int, src_slot: int) -> Optional[Inst]:
        """Defining instruction of the ``src_slot``-th *register* source."""
        if self._fast:
            t = self._t
            lo = t.ireg_off[seq]
            if src_slot >= t.ireg_off[seq + 1] - lo:
                return None
            prod = t.ent_prod[lo + src_slot]
            return self.trace.row(int(prod)) if prod >= 0 else None
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
        t = self._t
        row = self.trace.row
        tag, val, kind, prod = (self._src_tag, self._src_val,
                                self._src_kind, t.full_prod_l)
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
        accepted candidate — the partition step's bookkeeping.
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

    def cim_root_seqs(self, cim_set: FrozenSet[str]) -> np.ndarray:
        """Ascending seqs of every CiM-supported instruction (fast mode)."""
        codes = [OP_CODE[o] for o in cim_set if o in OP_CODE]
        return np.flatnonzero(np.isin(self.trace.op, codes))

    def build_forest(self, cim_set: FrozenSet[str],
                     max_ops: int = 64) -> List[IDGNode]:
        """Algorithm 2's outer loop: one tree per CiM-supported instruction.

        (Offload selection uses a claimed-set variant instead so composite
        candidates are extracted exactly once — see core/offload.py.)
        """
        forest = []
        if self._fast:
            for seq in self.cim_root_seqs(cim_set):
                tree = self.create_tree(self.trace.row(int(seq)), cim_set,
                                        max_ops=max_ops)
                if tree is not None:
                    forest.append(tree)
            return forest
        for inst in self.trace:
            if inst.op in cim_set:
                tree = self.create_tree(inst, cim_set, max_ops=max_ops)
                if tree is not None:
                    forest.append(tree)
        return forest


# ======================================================================
# Auxiliary producer/consumer indices used by selection + reshaping
# ======================================================================
class FlowIndex:
    """Derived O(N) flow maps over a trace (built once, reused everywhere).

    Columnar storage — four CSR/paired-array tables instead of dicts —
    with the original dict views available as lazy properties, so legacy
    consumers (``flow.reg_consumers[p]`` …) keep working while the hot
    selection path uses the O(1) array accessors:

      ``consumers_of(seq)``    register consumers of an op's value
      ``stores_of(seq)``       stores that spilled an op's value
      ``load_source_of(seq)``  producing op behind a load (−1: none)
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
        selection inner loop does tens of thousands of point lookups, and
        list slicing/indexing beats numpy scalar indexing ~10x there."""
        if self._py is None:
            full = np.full(self.n, -1, np.int64)
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
            def csr_dict(off, val):
                out: Dict[int, List[int]] = {}
                vals = val.tolist()
                offs = off.tolist()
                for seq in np.flatnonzero(np.diff(off)).tolist():
                    out[seq] = vals[offs[seq]:offs[seq + 1]]
                return out

            load_source = {}
            value_loads: Dict[int, List[int]] = {}
            for s, src in zip(self.ls_seq.tolist(), self.ls_src.tolist()):
                load_source[s] = None if src < 0 else src
                if src >= 0:
                    value_loads.setdefault(src, []).append(s)
            self._dicts = {
                "reg_consumers": csr_dict(self.rc_off, self.rc_val),
                "store_of": csr_dict(self.so_off, self.so_val),
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
        """Wrap dict tables built by the legacy (row-path) construction."""
        def dict_csr(d):
            off = np.zeros(n + 1, np.int64)
            for k, v in d.items():
                off[k + 1] = len(v)
            np.cumsum(off, out=off)
            val = np.empty(int(off[-1]), np.int64)
            for k, v in d.items():
                val[off[k]:off[k + 1]] = v
            return off, val

        rc_off, rc_val = dict_csr(reg_consumers)
        so_off, so_val = dict_csr(store_of)
        ls_seq = np.asarray(sorted(load_source), np.int64)
        ls_src = np.asarray([-1 if load_source[s] is None else load_source[s]
                             for s in ls_seq.tolist()], np.int64)
        return cls(n, rc_off, rc_val, so_off, so_val, ls_seq, ls_src,
                   dicts={"reg_consumers": reg_consumers,
                          "store_of": store_of,
                          "load_source": load_source,
                          "value_loads": value_loads})

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Array dict for .npz persistence (the analysis store)."""
        return {"flow_n": np.asarray([self.n], np.int64),
                "flow_rc_off": self.rc_off, "flow_rc_val": self.rc_val,
                "flow_so_off": self.so_off, "flow_so_val": self.so_val,
                "flow_ls_seq": self.ls_seq, "flow_ls_src": self.ls_src}

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]) -> "FlowIndex":
        return cls(int(arrays["flow_n"][0]),
                   arrays["flow_rc_off"], arrays["flow_rc_val"],
                   arrays["flow_so_off"], arrays["flow_so_val"],
                   arrays["flow_ls_seq"], arrays["flow_ls_src"])

    # ---------------------------------------------------------- pickling
    def __getstate__(self):
        return (self.n, self.rc_off, self.rc_val, self.so_off, self.so_val,
                self.ls_seq, self.ls_src)

    def __setstate__(self, state):
        (self.n, self.rc_off, self.rc_val, self.so_off, self.so_val,
         self.ls_seq, self.ls_src) = state
        self._py = None
        self._dicts = None


def _build_flow_columnar(ct: ColumnarTrace) -> FlowIndex:
    """Vectorized flow construction over the structural columns."""
    t = _tables(ct)
    n = ct.n
    valid = t.ent_prod >= 0
    prod_v = t.ent_prod[valid]
    cons_v = t.ent_seq[valid]

    def group_csr(prods, vals):
        order = np.argsort(prods, kind="stable")
        off = np.zeros(n + 1, np.int64)
        if len(prods):
            np.cumsum(np.bincount(prods, minlength=n), out=off[1:])
        return off, vals[order]

    rc_off, rc_val = group_csr(prod_v, cons_v)
    cons_is_store = ct.op[cons_v] == OP_STORE if len(cons_v) \
        else np.zeros(0, bool)
    so_off, so_val = group_csr(prod_v[cons_is_store], cons_v[cons_is_store])

    # --- memory flow: each load's producing op via the last store to its
    # address with a resolvable producer (stores without one leave the
    # previous mapping intact, exactly like the incremental construction)
    mem_idx = np.flatnonzero(ct.mem_mask)
    m = len(mem_idx)
    if m == 0:
        return FlowIndex(n, rc_off, rc_val, so_off, so_val,
                         np.zeros(0, np.int64), np.zeros(0, np.int64))
    ev_is_store = ct.op[mem_idx] == OP_STORE
    # first resolved producer per store instruction
    ev_prod = np.full(m, -1, np.int64)
    if len(cons_v):
        s_seq = cons_v[cons_is_store]
        s_prod = prod_v[cons_is_store]
        uniq, first = np.unique(s_seq, return_index=True)
        pos = np.searchsorted(uniq, mem_idx)
        ok = (pos < len(uniq))
        ok[ok] = uniq[pos[ok]] == mem_idx[ok]
        ev_prod[ok] = s_prod[first[pos[ok]]]
    participate = ev_prod >= 0                       # producer-carrying stores

    order = np.argsort(ct.addr[mem_idx], kind="stable")   # addr-major
    a_sorted = ct.addr[mem_idx][order]
    new_grp = np.empty(m, bool)
    new_grp[0] = True
    new_grp[1:] = a_sorted[1:] != a_sorted[:-1]
    gid = np.cumsum(new_grp) - 1
    # segmented running "last participating store": offset the positions by
    # group so the cummax can never leak across address groups
    v = np.where(participate[order], np.arange(m, dtype=np.int64), -1)
    base = gid * (m + 1)
    w = np.where(v >= 0, v + base, base - 1)
    res = np.maximum.accumulate(w) - base
    last = np.where(res >= 0, res, -1)

    load_pos = np.flatnonzero(~ev_is_store[order])
    lsrc = np.where(last[load_pos] >= 0,
                    ev_prod[order[np.maximum(last[load_pos], 0)]], -1)
    load_seqs = mem_idx[order[load_pos]]
    o2 = np.argsort(load_seqs)
    return FlowIndex(n, rc_off, rc_val, so_off, so_val,
                     load_seqs[o2], lsrc[o2])


def _build_flow_rows(trace: Trace, rut, iht) -> FlowIndex:
    """The original object-at-a-time construction (hand-built traces)."""
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


def build_flow_index(trace: Trace, rut=None, iht=None) -> FlowIndex:
    """Flow tables for a trace — vectorized for columnar traces (cached on
    the structural trace, so every geometry variant shares one build),
    object-at-a-time for hand-built ``List[Inst]`` traces."""
    if isinstance(trace, ColumnarTrace):
        flow = trace._struct.get("flow")
        if flow is None:
            flow = trace._struct["flow"] = _build_flow_columnar(trace)
        return flow
    return _build_flow_rows(trace, rut, iht)
