"""Offloading-candidate selection — the paper's Algorithm 1.

Walks the CIQ in reverse order (outermost consumers first, so composite
patterns are extracted maximally), builds the IDG tree under each
CiM-supported root (Algorithm 2 via :mod:`cimbench.ref.idg`), then applies
the paper's §IV-A/§IV-B constraints:

  * every op node's operation must be in the CiM-supported set;
  * leaves are loads, immediates, or memory-resident values;
  * at least one operand must actually come from memory;
  * the operands must co-reside at one CiM-capable cache level — operands
    at a *shallower* level can be written back to the offload level
    (§IV-C's reshaping rule, priced as `moves`), operands at a *deeper*
    level than any CiM-capable cache make the candidate infeasible there.

Dependent candidates from the same IDG tree (the output of one subtree
feeding another, Fig. 5c) are merged through memory: the connecting
load+store pair is elided and counted as an in-bank move (`internal_edges`).

Over a columnar trace the algorithm splits into two phases with different
dependence keys, mirroring the trace/replay split one layer down:

  * **partition** (structural) — tree extraction and the removal sets.
    With cross-level writeback enabled and no same-bank constraint
    (every sweep configuration), acceptance does not depend on *where*
    a leaf resides — a deeper-than-capable leaf is lifted, a shallower
    one moves — so the partition depends only on the program and the
    CiM op set.  It is computed once per (structural trace, op set) and
    shared across every cache geometry and CiM level set of a sweep.
  * **placement** (per geometry/level set) — vectorized: offload levels,
    cross-level moves, banks, and surviving DRAM fills, from the
    level/bank columns with `reduceat`/`bincount` segment operations.

Hand-built ``List[Inst]`` traces (and configs with the same-bank or
no-cross-level constraints, where acceptance *is* placement-dependent)
run the original single-pass algorithm; both paths produce identical
results (property-tested in ``tests/test_columnar.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Dict, FrozenSet, Iterator, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from cimbench.ref.columnar import ColumnarTrace
from cimbench.ref.idg import (LEAF_IMM, LEAF_LOAD, LEAF_MEMVAL, FlowIndex,
                            IDGBuilder, IDGNode, build_flow_index)
from cimbench.ref.isa import (CIM_OP_CLASS, CIM_SET_STT, LEVEL_L1, LEVEL_MEM,
                            OPS, OP_STORE, Inst, Trace)

_LEVEL_DEPTH = {"L1": 0, "L2": 1, "MEM": 2}
_DEPTH_LEVEL = {v: k for k, v in _LEVEL_DEPTH.items()}

# Version of the *analysis* semantics layered on top of the trace: IDG/flow
# construction (core/idg.py), candidate selection (this module), and trace
# reshaping (core/reshape.py) — plus the serialized shape of their
# artifacts.  Bump whenever any of them would produce different artifacts
# for an unchanged trace — the on-disk analysis store
# keys flow and selection artifacts by this number, so a selection-rule (or
# flow-encoding) change invalidates persisted results instead of silently
# re-serving pre-change numbers.  (Trace lowering changes are covered
# separately by cimbench.ref.trace.TRACE_VM_VERSION.)
# v2: FlowIndex became columnar (CSR arrays instead of pickled dicts).
ANALYSIS_VERSION = 2


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    cim_set: FrozenSet[str] = CIM_SET_STT
    cim_levels: Tuple[str, ...] = ("L1", "L2")   # CiM-capable cache levels
    require_same_bank: bool = False   # off: assume [18]/[20]-style operand-
                                      # locality support (address translation)
    allow_cross_level: bool = True    # §IV-C writeback of shallower operands
    min_mem_operands: int = 1
    # the paper's IDG leaf rule: "the leaf node needs to be either a load
    # instruction or an immediate value" — at least one true load leaf,
    # otherwise offloading saves nothing (it would only add re-loads)
    min_load_leaves: int = 1
    max_tree_ops: int = 64

    def partition_key(self) -> Tuple:
        """The structural-phase dependence key (see module docstring)."""
        return (self.cim_set, self.min_mem_operands, self.min_load_leaves,
                self.max_tree_ops)


@dataclasses.dataclass
class Candidate:
    """One accepted offloading candidate (a subtree of one IDG tree)."""
    root_seq: int
    op_seqs: List[int]                 # CiM-executed op nodes (root included)
    op_classes: List[str]              # Table III pricing class per op node
    load_seqs: List[int]               # converted (removed) host loads
    store_seqs: List[int]              # stores absorbed into CiM writes
    level: str                         # offload level
    bank: Optional[int]
    moves: int                         # operands written back to `level`
    internal_edges: int                # merged same-tree subtree links
    added_loads: int                   # outside reg-consumers now load from mem
    memval_leaves: int
    dram_fills: int = 0                # leaves/stores whose line sat in DRAM —
                                       # the fill happens in BOTH scenarios

    @property
    def n_ops(self) -> int:
        return len(self.op_seqs)

    @property
    def converted_accesses(self) -> int:
        return len(self.load_seqs) + len(self.store_seqs)


@dataclasses.dataclass
class OffloadResult:
    candidates: List[Candidate]
    claimed: Set[int]                  # all removed host instruction seqs
    flow: FlowIndex
    config: OffloadConfig

    # compact pickling: the claimed set covers most of the trace — a packed
    # sorted array is ~10x smaller than a pickled set of Python ints
    def __getstate__(self):
        state = self.__dict__.copy()
        state["claimed"] = np.asarray(sorted(self.claimed), np.int32)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.claimed = set(state["claimed"].tolist())

    # ------------------------------------------------------------ metrics
    def macr(self, trace: Trace) -> float:
        """Memory-access conversion ratio (the paper's §VI-C metric)."""
        if isinstance(trace, ColumnarTrace):
            total = trace.mem_accesses()
        else:
            total = sum(1 for i in trace if i.is_mem)
        if total == 0:
            return 0.0
        converted = sum(c.converted_accesses for c in self.candidates)
        return converted / total

    def macr_breakdown(self, trace: Trace) -> Dict[str, float]:
        """Fig. 13: converted accesses split into L1 / other levels."""
        if isinstance(trace, ColumnarTrace):
            total = max(1, trace.mem_accesses())
            seqs = list(itertools.chain.from_iterable(
                c.load_seqs + c.store_seqs for c in self.candidates))
            if seqs:
                lv = trace.level[np.asarray(seqs, np.int64)]
                l1 = int((lv == LEVEL_L1).sum())
                other = len(seqs) - l1
            else:
                l1 = other = 0
        else:
            total = max(1, sum(1 for i in trace if i.is_mem))
            l1 = other = 0
            for c in self.candidates:
                for s in c.load_seqs + c.store_seqs:
                    if trace[s].level == "L1":
                        l1 += 1
                    else:
                        other += 1
        return {"macr": (l1 + other) / total, "l1": l1 / total,
                "other": other / total,
                "total_accesses": total, "converted": l1 + other}


# ======================================================================
# Generic (single-pass) acceptance — row traces + placement-constrained cfgs
# ======================================================================
def _leaf_levels(node: IDGNode, flow: FlowIndex, trace: Trace
                 ) -> Optional[List[Tuple[str, Optional[int], str, int]]]:
    """(kind, seq, level, bank) per memory-resident operand of a subtree."""
    out = []
    for kind, payload in node.children:
        if kind == LEAF_LOAD:
            inst: Inst = payload
            out.append((LEAF_LOAD, inst.seq, inst.level, inst.bank))
        elif kind == LEAF_MEMVAL:
            inst: Inst = payload
            stores = flow.stores_of(inst.seq)
            if not stores:
                return None                      # value never reached memory
            st = trace[stores[-1]]
            out.append((LEAF_MEMVAL, inst.seq, st.level, st.bank))
        elif kind == "node":
            sub = _leaf_levels(payload, flow, trace)
            if sub is None:
                return None
            out.extend(sub)
    return out


def _try_accept(node: IDGNode, flow: FlowIndex, trace: Trace,
                cfg: OffloadConfig, claimed: Set[int]) -> Optional[Candidate]:
    ops = list(node.iter_nodes())
    if any(n.inst.seq in claimed for n in ops):
        return None
    leaves = _leaf_levels(node, flow, trace)
    if leaves is None:
        return None
    mem_leaves = [l for l in leaves if l[0] in (LEAF_LOAD, LEAF_MEMVAL)]
    if len(mem_leaves) < cfg.min_mem_operands:
        return None
    if sum(1 for l in leaves if l[0] == LEAF_LOAD) < cfg.min_load_leaves:
        return None

    # ---- locality: pick the offload level (deepest leaf level among
    # CiM-capable levels); deeper-than-capable leaves are infeasible.
    depth_cap = max(_LEVEL_DEPTH[l] for l in cfg.cim_levels)
    max_depth = 0
    for _, _, level, _ in mem_leaves:
        d = _LEVEL_DEPTH.get(level, 2)
        if d > depth_cap:
            # data currently in DRAM (or below any CiM cache): the fill
            # happens in both scenarios — offload at the deepest CiM level.
            d = depth_cap
        max_depth = max(max_depth, d)
    # lift to the shallowest *enabled* level >= max_depth
    enabled_depths = sorted(_LEVEL_DEPTH[l] for l in cfg.cim_levels)
    target_depth = next((d for d in enabled_depths if d >= max_depth),
                        enabled_depths[-1])
    level = _DEPTH_LEVEL[target_depth]
    moves = sum(1 for _, _, lv, _ in mem_leaves
                if _LEVEL_DEPTH.get(lv, 2) < target_depth)
    if moves and not cfg.allow_cross_level:
        return None

    if cfg.require_same_bank:
        banks = {b for _, _, lv, b in mem_leaves if lv == level}
        if len(banks) > 1:
            return None

    # ---- gather the removal set --------------------------------------
    op_seqs = [n.inst.seq for n in ops]
    op_set = set(op_seqs)
    # loads/stores already claimed by an earlier candidate are shared
    # operands (the value is already array-resident) — never count twice
    load_seqs = sorted({s for k, s, _, _ in leaves if k == LEAF_LOAD}
                       - claimed)
    internal = 0
    # dependent-subtree merge: converted loads whose value was produced by
    # an op we also offload become in-bank moves (Fig. 5c)
    for s in load_seqs:
        src = flow.load_source_of(s)
        if src >= 0 and src in op_set:
            internal += 1
    store_set: Set[int] = set()
    added_loads = 0
    root_seq = node.inst.seq
    for p in op_seqs:
        store_set.update(s for s in flow.stores_of(p)
                         if s not in claimed)
        if p == root_seq:
            # the CiM macro-instruction is read-class ([23]): the root's
            # result returns to the host destination register like a load
            # result — its register consumers need no re-load
            continue
        for consumer in flow.consumers_of(p):  # outside reg readers
            # consumers claimed by *other* candidates read the value in the
            # array (selection runs in reverse order, so later consumers are
            # already resolved); only surviving host ops re-load it
            if (consumer not in op_set and consumer not in claimed
                    and not trace[consumer].is_store):
                added_loads += 1
    store_seqs = sorted(store_set)
    bank = trace[load_seqs[0]].bank if load_seqs else None
    # DRAM fills kept in both scenarios: one per unique line this candidate
    # touches whose access was served by main memory.
    fill_lines = {trace[s].addr // 64 for s in load_seqs
                  if trace[s].level == "MEM"}
    fill_lines |= {trace[s].addr // 64 for s in store_seqs
                   if trace[s].level == "MEM"}
    dram_fills = len(fill_lines)
    return Candidate(
        root_seq=node.inst.seq,
        op_seqs=op_seqs,
        op_classes=[CIM_OP_CLASS.get(trace[s].op, "CiM-ADD") for s in op_seqs],
        load_seqs=load_seqs,
        store_seqs=store_seqs,
        level=level,
        bank=bank,
        moves=moves,
        internal_edges=internal,
        added_loads=added_loads,
        memval_leaves=sum(1 for k, *_ in leaves if k == LEAF_MEMVAL),
        dram_fills=dram_fills,
    )


# ======================================================================
# Columnar fast path: structural partition + vectorized placement
# ======================================================================
@dataclasses.dataclass
class _ProtoCandidate:
    """Structural (placement-free) half of one accepted candidate."""
    root_seq: int
    op_seqs: List[int]
    op_classes: List[str]
    load_seqs: List[int]
    store_seqs: List[int]
    internal_edges: int
    added_loads: int
    memval_leaves: int
    leaf_src: List[int]               # per mem leaf: load / last-store seq


@dataclasses.dataclass
class SelectionPartition:
    """Output of the structural phase: the candidate partition of one
    trace under one CiM op set (shared across geometries/level sets)."""
    protos: List[_ProtoCandidate]
    claimed: Set[int]


class _SeqNode:
    """Skeleton IDG node for the structural partition: sequence indices
    only, no ``Inst`` materialization.  ``children`` entries are
    ``("node", _SeqNode)`` / ``(LEAF_LOAD, seq)`` / ``(LEAF_MEMVAL, seq)``
    — immediate leaves carry no structural information and are omitted."""

    __slots__ = ("seq", "children")

    def __init__(self, seq: int):
        self.seq = seq
        self.children: List[Tuple[str, object]] = []

    def iter_seqs(self) -> Iterator[int]:          # pre-order, like IDGNode
        yield self.seq
        for kind, payload in self.children:
            if kind == "node":
                yield from payload.iter_seqs()


def _create_seq_tree(root_seq: int, ct_lists, cim_codes: FrozenSet[int],
                     claimed: Set[int], max_ops: int) -> Optional[_SeqNode]:
    """Algorithm 2's create_tree over raw sequence indices (fast path).

    Exactly :meth:`IDGBuilder.create_tree`'s recursion — same producer
    resolution, same mov-immediate collapse, same claimed/budget cuts —
    expressed over the integer columns."""
    op_l, src_off_l, prod_l, ireg_off_l, mov_code, load_code = ct_lists
    budget = [max_ops]

    def build(seq: int) -> Optional[_SeqNode]:
        if budget[0] <= 0:
            return None
        budget[0] -= 1
        node = _SeqNode(seq)
        children = node.children
        for j in range(src_off_l[seq], src_off_l[seq + 1]):
            p = prod_l[j]
            if p < 0:
                continue                          # immediate / unknown leaf
            p_op = op_l[p]
            if p_op == load_code:
                children.append((LEAF_LOAD, p))
            elif p_op == mov_code and ireg_off_l[p] == ireg_off_l[p + 1]:
                continue                          # accumulator init: imm leaf
            elif p_op in cim_codes and p not in claimed:
                sub = build(p)
                children.append((LEAF_MEMVAL, p) if sub is None
                                else ("node", sub))
            else:
                children.append((LEAF_MEMVAL, p))
        return node

    return build(root_seq)


def _leaf_sources(node: _SeqNode, flow: FlowIndex
                  ) -> Optional[List[Tuple[str, int]]]:
    """(kind, residence seq) per memory-resident operand of a subtree —
    the structural analogue of :func:`_leaf_levels` (levels attach later)."""
    out = []
    for kind, payload in node.children:
        if kind == LEAF_LOAD:
            out.append((LEAF_LOAD, payload))
        elif kind == LEAF_MEMVAL:
            stores = flow.stores_of(payload)
            if not stores:
                return None                      # value never reached memory
            out.append((LEAF_MEMVAL, stores[-1]))
        else:
            sub = _leaf_sources(payload, flow)
            if sub is None:
                return None
            out.extend(sub)
    return out


def _try_accept_structural(node: _SeqNode, flow: FlowIndex, op_col: List[int],
                           cfg: OffloadConfig, claimed: Set[int]
                           ) -> Optional[_ProtoCandidate]:
    children = node.children
    if not any(k == "node" for k, _ in children):
        # single-op tree (the overwhelmingly common shape): no subtree
        # recursion, no outside register consumers beyond the root's (whose
        # result returns in-register), so the removal set is direct
        seq = node.seq
        if seq in claimed:
            return None
        loads = [s for k, s in children if k == LEAF_LOAD]
        n_leaves = len(children)          # imm leaves were never appended
        memvals = n_leaves - len(loads)
        if n_leaves < cfg.min_mem_operands or len(loads) < cfg.min_load_leaves:
            return None
        leaf_src = []
        for kind, s in children:
            if kind == LEAF_LOAD:
                leaf_src.append(s)
            else:
                stores = flow.stores_of(s)
                if not stores:
                    return None
                leaf_src.append(stores[-1])
        load_seqs = sorted(set(loads) - claimed)
        load_source_of = flow.load_source_of
        internal = sum(1 for s in load_seqs if load_source_of(s) == seq)
        return _ProtoCandidate(
            root_seq=seq, op_seqs=[seq],
            op_classes=[CIM_OP_CLASS.get(OPS[op_col[seq]], "CiM-ADD")],
            load_seqs=load_seqs,
            store_seqs=sorted(s for s in flow.stores_of(seq)
                              if s not in claimed),
            internal_edges=internal, added_loads=0, memval_leaves=memvals,
            leaf_src=leaf_src)

    op_seqs = list(node.iter_seqs())
    if not claimed.isdisjoint(op_seqs):
        return None
    leaves = _leaf_sources(node, flow)
    if leaves is None:
        return None
    if len(leaves) < cfg.min_mem_operands:
        return None
    if sum(1 for k, _ in leaves if k == LEAF_LOAD) < cfg.min_load_leaves:
        return None

    op_set = set(op_seqs)
    load_seqs = sorted({s for k, s in leaves if k == LEAF_LOAD} - claimed)
    internal = 0
    for s in load_seqs:
        src = flow.load_source_of(s)
        if src >= 0 and src in op_set:
            internal += 1
    store_set: Set[int] = set()
    added_loads = 0
    root_seq = node.seq
    for p in op_seqs:
        store_set.update(s for s in flow.stores_of(p)
                         if s not in claimed)
        if p == root_seq:
            continue
        for consumer in flow.consumers_of(p):
            if (consumer not in op_set and consumer not in claimed
                    and op_col[consumer] != OP_STORE):
                added_loads += 1
    return _ProtoCandidate(
        root_seq=root_seq,
        op_seqs=op_seqs,
        op_classes=[CIM_OP_CLASS.get(OPS[op_col[s]], "CiM-ADD")
                    for s in op_seqs],
        load_seqs=load_seqs,
        store_seqs=sorted(store_set),
        internal_edges=internal,
        added_loads=added_loads,
        memval_leaves=sum(1 for k, _ in leaves if k == LEAF_MEMVAL),
        leaf_src=[s for _, s in leaves],
    )


def _partition(ct: ColumnarTrace, builder: IDGBuilder, flow: FlowIndex,
               cfg: OffloadConfig) -> SelectionPartition:
    """Algorithm 1's reverse-order tree extraction, structural fields only.

    Memoized per (structural trace, partition key) on the trace's shared
    ``_struct`` dict — one partition serves every geometry and CiM level
    set of a sweep."""
    memo = ct._struct.setdefault("partitions", {})
    hit = memo.get(cfg.partition_key())
    if hit is not None:
        return hit
    from cimbench.ref.idg import _tables
    from cimbench.ref.isa import OP_CODE, OP_LOAD, OP_MOV
    t = _tables(ct)
    op_col = ct.op.tolist()
    ct_lists = (op_col, t.src_off_l, t.full_prod_l, t.ireg_off.tolist(),
                OP_MOV, OP_LOAD)
    cim_codes = frozenset(OP_CODE[o] for o in cfg.cim_set if o in OP_CODE)
    claimed: Set[int] = set()
    protos: List[_ProtoCandidate] = []
    roots = builder.cim_root_seqs(cfg.cim_set)
    for seq in roots[::-1].tolist():
        if seq in claimed:
            continue
        tree = _create_seq_tree(seq, ct_lists, cim_codes, claimed,
                                cfg.max_tree_ops)
        if tree is None:
            continue
        proto = _try_accept_structural(tree, flow, op_col, cfg, claimed)
        if proto is None:
            # Fig. 5: the whole tree failed — try its child subtrees
            for kind, payload in tree.children:
                if kind == "node":
                    sub = _try_accept_structural(payload, flow, op_col, cfg,
                                                 claimed)
                    if sub is not None:
                        protos.append(sub)
                        claimed.update(sub.op_seqs)
                        claimed.update(sub.load_seqs)
                        claimed.update(sub.store_seqs)
            continue
        protos.append(proto)
        claimed.update(proto.op_seqs)
        claimed.update(proto.load_seqs)
        claimed.update(proto.store_seqs)
    protos.reverse()                         # report in program order
    part = SelectionPartition(protos, claimed)
    memo[cfg.partition_key()] = part
    return part


def _place(part: SelectionPartition, ct: ColumnarTrace,
           cfg: OffloadConfig) -> List[Candidate]:
    """Vectorized placement: levels, moves, banks, DRAM fills per proto."""
    protos = part.protos
    if not protos:
        return []
    depth_cap = max(_LEVEL_DEPTH[l] for l in cfg.cim_levels)
    enabled = np.asarray(sorted(_LEVEL_DEPTH[l] for l in cfg.cim_levels))

    leaf_counts = np.asarray([len(p.leaf_src) for p in protos], np.int64)
    off = np.zeros(len(protos) + 1, np.int64)
    np.cumsum(leaf_counts, out=off[1:])
    all_leaf = np.asarray(list(itertools.chain.from_iterable(
        p.leaf_src for p in protos)), np.int64)
    nonempty = leaf_counts > 0

    # depth per leaf (level codes are 1=L1, 2=L2, 3=MEM -> depth = code-1),
    # clamped at the deepest CiM-capable level (DRAM-resident operands fill
    # in both scenarios)
    depth = np.minimum(ct.level[all_leaf].astype(np.int64) - 1, depth_cap)
    max_depth = np.zeros(len(protos), np.int64)
    if len(all_leaf):
        seg_max = np.maximum.reduceat(depth, np.minimum(off[:-1],
                                                        len(all_leaf) - 1))
        max_depth[nonempty] = seg_max[nonempty]
    # lift to the shallowest enabled level >= max_depth
    tpos = np.minimum(np.searchsorted(enabled, max_depth), len(enabled) - 1)
    target = enabled[tpos]
    moves = np.zeros(len(protos), np.int64)
    if len(all_leaf):
        shallower = (depth < np.repeat(target, leaf_counts)).astype(np.int64)
        seg_sum = np.add.reduceat(shallower, np.minimum(off[:-1],
                                                        len(all_leaf) - 1))
        moves[nonempty] = seg_sum[nonempty]

    # DRAM fills: unique (proto, line) pairs among converted accesses whose
    # access was served by main memory
    acc_counts = np.asarray([len(p.load_seqs) + len(p.store_seqs)
                             for p in protos], np.int64)
    acc_seqs = np.asarray(list(itertools.chain.from_iterable(
        p.load_seqs + p.store_seqs for p in protos)), np.int64)
    fills = np.zeros(len(protos), np.int64)
    if len(acc_seqs):
        pid = np.repeat(np.arange(len(protos)), acc_counts)
        in_mem = ct.level[acc_seqs] == LEVEL_MEM
        if in_mem.any():
            lines = ct.addr[acc_seqs[in_mem]] // 64
            key = pid[in_mem] * (1 << 40) + lines
            uniq_pid = np.unique(key) >> 40
            fills += np.bincount(uniq_pid, minlength=len(protos))

    bank_col = ct.bank
    level_of = [_DEPTH_LEVEL[int(d)] for d in target]
    out = []
    for i, p in enumerate(protos):
        out.append(Candidate(
            root_seq=p.root_seq, op_seqs=p.op_seqs, op_classes=p.op_classes,
            load_seqs=p.load_seqs, store_seqs=p.store_seqs,
            level=level_of[i],
            bank=int(bank_col[p.load_seqs[0]]) if p.load_seqs else None,
            moves=int(moves[i]), internal_edges=p.internal_edges,
            added_loads=p.added_loads, memval_leaves=p.memval_leaves,
            dram_fills=int(fills[i])))
    return out


# ======================================================================
# Analysis bundle + entry points
# ======================================================================
class TraceAnalysis:
    """Config-independent artifacts of one traced workload.

    Everything here depends only on the program (and, for the level/bank
    columns consulted at placement time, the cache hierarchy it was
    replayed under) — not on the CiM level set, op set, or technology.
    Building it once and pricing many configurations against it is what
    makes design-space sweeps cheap (see the DSE engine).  For
    columnar traces the builder, flow index, and selection partitions are
    shared through the structural trace's memo, so geometry variants of
    one workload reuse them automatically.
    """

    def __init__(self, trace: Trace, rut=None, iht=None,
                 builder: Optional[IDGBuilder] = None,
                 flow: Optional[FlowIndex] = None):
        self.trace = trace
        self._rut = rut
        self._iht = iht
        self.builder = builder or IDGBuilder(trace, rut, iht)
        self.flow = flow if flow is not None \
            else build_flow_index(trace, rut, iht)

    @property
    def rut(self):
        if self._rut is None and isinstance(self.trace, ColumnarTrace):
            return self.trace.rut
        return self._rut

    @property
    def iht(self):
        if self._iht is None and isinstance(self.trace, ColumnarTrace):
            return self.trace.iht
        return self._iht

    def select(self, cfg: OffloadConfig = OffloadConfig()) -> OffloadResult:
        """Run Algorithm 1 against these artifacts for one configuration."""
        return select_candidates(self.trace, self._rut, self._iht, cfg,
                                 flow=self.flow, builder=self.builder)


def analyze_trace(tr) -> TraceAnalysis:
    """Build the reusable IDG/flow artifacts for a ``TraceResult`` (or any
    object exposing ``trace`` — plus ``rut``/``iht`` for row traces)."""
    trace = tr.trace
    if isinstance(trace, ColumnarTrace):
        return TraceAnalysis(trace)
    return TraceAnalysis(trace, tr.rut, tr.iht)


def rehydrate_analysis(tr, flow: FlowIndex) -> TraceAnalysis:
    """Reassemble a :class:`TraceAnalysis` from persisted artifacts.

    The only *derived* table worth storing is the :class:`FlowIndex`
    (:class:`IDGBuilder` is a stateless view over the trace), so the
    on-disk analysis store saves ``(TraceResult, FlowIndex)`` and this hook
    rebuilds the full analysis without re-walking the trace."""
    trace = tr.trace
    if isinstance(trace, ColumnarTrace):
        trace._struct.setdefault("flow", flow)
        return TraceAnalysis(trace, flow=flow)
    return TraceAnalysis(trace, tr.rut, tr.iht, flow=flow)


def select_candidates(trace: Trace, rut=None, iht=None,
                      cfg: OffloadConfig = OffloadConfig(),
                      flow: Optional[FlowIndex] = None,
                      builder: Optional[IDGBuilder] = None) -> OffloadResult:
    """Algorithm 1: build tables -> build IDG trees -> partition/extract."""
    builder = builder or IDGBuilder(trace, rut, iht)
    flow = flow or build_flow_index(trace, rut, iht)

    if isinstance(trace, ColumnarTrace):
        if cfg.allow_cross_level and not cfg.require_same_bank:
            # structural partition (shared across geometries) + placement
            part = _partition(trace, builder, flow, cfg)
            return OffloadResult(_place(part, trace, cfg), part.claimed,
                                 flow, cfg)
        # placement-dependent acceptance: single-pass over CiM roots only
        claimed: Set[int] = set()
        candidates: List[Candidate] = []
        for seq in builder.cim_root_seqs(cfg.cim_set)[::-1].tolist():
            if seq in claimed:
                continue
            tree = builder.create_tree(trace.row(seq), cfg.cim_set,
                                       claimed=claimed,
                                       max_ops=cfg.max_tree_ops)
            if tree is None:
                continue
            _accept_or_descend(tree, flow, trace, cfg, claimed, candidates)
        candidates.reverse()
        return OffloadResult(candidates, claimed, flow, cfg)

    claimed = set()
    candidates = []
    # reverse order: outermost roots first => maximal composite extraction
    for seq in range(len(trace) - 1, -1, -1):
        inst = trace[seq]
        if inst.op not in cfg.cim_set or seq in claimed:
            continue
        tree = builder.create_tree(inst, cfg.cim_set, claimed=claimed,
                                   max_ops=cfg.max_tree_ops)
        if tree is None:
            continue
        _accept_or_descend(tree, flow, trace, cfg, claimed, candidates)

    candidates.reverse()                     # report in program order
    return OffloadResult(candidates, claimed, flow, cfg)


def _accept_or_descend(tree: IDGNode, flow: FlowIndex, trace: Trace,
                       cfg: OffloadConfig, claimed: Set[int],
                       candidates: List[Candidate]) -> None:
    """Accept the whole tree, or (Fig. 5) its immediate child subtrees."""
    cand = _try_accept(tree, flow, trace, cfg, claimed)
    if cand is None:
        for kind, payload in tree.children:
            if kind == "node":
                sub = _try_accept(payload, flow, trace, cfg, claimed)
                if sub is not None:
                    candidates.append(sub)
                    claimed.update(sub.op_seqs)
                    claimed.update(sub.load_seqs)
                    claimed.update(sub.store_seqs)
        return
    candidates.append(cand)
    claimed.update(cand.op_seqs)
    claimed.update(cand.load_seqs)
    claimed.update(cand.store_seqs)
