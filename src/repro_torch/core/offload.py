"""Offloading-candidate selection -- the paper's Algorithm 1, columnar branch.

Twin of ``repro/core/offload.py``.  Over a columnar trace the algorithm
splits into two phases with different dependence keys:

  * **partition** (structural) -- reverse-order IDG tree extraction and the
    removal sets.  With cross-level writeback enabled and no same-bank
    constraint (every sweep configuration), acceptance does not depend on
    *where* a leaf resides, so the partition depends only on the program
    and the CiM op set.  It walks Python lists on the host, in the
    reference's order, and is memoized per (structural trace, op set).
  * **placement** (per geometry/level set) -- offload levels, cross-level
    moves, banks and surviving DRAM fills.  On a CUDA trace it runs on the
    card through :func:`repro_torch.core.accel.place.place_candidates`
    (one launch of the placement kernel); on a CPU trace through the
    kernel's plain version.

The single-pass branch (``require_same_bank=True`` or
``allow_cross_level=False``) and hand-built ``List[Inst]`` traces belong to
a later slice and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

import torch

from repro_torch.core.accel.place import place_candidates
from repro_torch.core.columnar import ColumnarTrace, resolve_device
from repro_torch.core.idg import (LEAF_LOAD, LEAF_MEMVAL, FlowIndex,
                                  IDGBuilder, _tables, build_flow_index)
from repro_torch.core.isa import (CIM_OP_CLASS, CIM_SET_STT, LEVEL_L1,
                                  LEVEL_MEM, OP_CODE, OP_LOAD, OP_MOV, OPS,
                                  OP_STORE)

_LEVEL_DEPTH = {"L1": 0, "L2": 1, "MEM": 2}
_DEPTH_LEVEL = {v: k for k, v in _LEVEL_DEPTH.items()}

# The reference's analysis-semantics version (IDG/flow construction,
# selection, reshaping).  The port implements exactly this version; the
# trace fixtures record it.
ANALYSIS_VERSION = 2

_SINGLE_PASS = ("the single-pass Algorithm 1 branch (require_same_bank=True "
                "or allow_cross_level=False) and List[Inst] traces are not "
                "ported yet (ROADMAP Queue 1)")


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    cim_set: FrozenSet[str] = CIM_SET_STT
    cim_levels: Tuple[str, ...] = ("L1", "L2")   # CiM-capable cache levels
    require_same_bank: bool = False   # off: assume [18]/[20]-style operand-
                                      # locality support (address translation)
    allow_cross_level: bool = True    # §IV-C writeback of shallower operands
    min_mem_operands: int = 1
    # the paper's IDG leaf rule: at least one true load leaf
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
    dram_fills: int = 0                # leaves/stores whose line sat in DRAM

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

    def macr(self, trace: ColumnarTrace) -> float:
        """Memory-access conversion ratio (the paper's §VI-C metric)."""
        total = trace.mem_accesses()
        if total == 0:
            return 0.0
        converted = sum(c.converted_accesses for c in self.candidates)
        return converted / total

    def macr_breakdown(self, trace: ColumnarTrace) -> Dict[str, float]:
        """Fig. 13: converted accesses split into L1 / other levels."""
        total = max(1, trace.mem_accesses())
        seqs = list(itertools.chain.from_iterable(
            c.load_seqs + c.store_seqs for c in self.candidates))
        if seqs:
            lv = trace.level[torch.tensor(seqs, dtype=torch.int64,
                                          device=trace.device)]
            l1 = int((lv == LEVEL_L1).sum())
            other = len(seqs) - l1
        else:
            l1 = other = 0
        return {"macr": (l1 + other) / total, "l1": l1 / total,
                "other": other / total,
                "total_accesses": total, "converted": l1 + other}


# ======================================================================
# Structural partition
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
    only.  ``children`` entries are ``("node", _SeqNode)`` /
    ``(LEAF_LOAD, seq)`` / ``(LEAF_MEMVAL, seq)`` -- immediate leaves carry
    no structural information and are omitted."""

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
    """Algorithm 2's create_tree over raw sequence indices: producer
    resolution, mov-immediate collapse and claimed/budget cuts exactly as
    the reference's ``IDGBuilder.create_tree``."""
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
    """(kind, residence seq) per memory-resident operand of a subtree."""
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
        # single-op tree (the overwhelmingly common shape): the removal set
        # is direct
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
    ``_struct`` dict -- one partition serves every geometry and CiM level
    set of a sweep."""
    memo = ct._struct.setdefault("partitions", {})
    hit = memo.get(cfg.partition_key())
    if hit is not None:
        return hit
    t = _tables(ct)
    op_col = ct.op.tolist()
    ct_lists = (op_col, t.src_off_l, t.full_prod_l, t.ireg_off.tolist(),
                OP_MOV, OP_LOAD)
    cim_codes = frozenset(OP_CODE[o] for o in cfg.cim_set if o in OP_CODE)
    claimed: Set[int] = set()
    protos: List[_ProtoCandidate] = []
    roots = builder.cim_root_seqs(cfg.cim_set)
    for seq in roots.flip(0).tolist():
        if seq in claimed:
            continue
        tree = _create_seq_tree(seq, ct_lists, cim_codes, claimed,
                                cfg.max_tree_ops)
        if tree is None:
            continue
        proto = _try_accept_structural(tree, flow, op_col, cfg, claimed)
        if proto is None:
            # Fig. 5: the whole tree failed -- try its child subtrees
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


# ======================================================================
# Placement
# ======================================================================
def _candidates(protos: List[_ProtoCandidate], target: List[int],
                moves: List[int], fills: List[int],
                banks: List[int]) -> List[Candidate]:
    """Join the structural protos with their per-geometry placement."""
    out = []
    for i, p in enumerate(protos):
        out.append(Candidate(
            root_seq=p.root_seq, op_seqs=p.op_seqs, op_classes=p.op_classes,
            load_seqs=p.load_seqs, store_seqs=p.store_seqs,
            level=_DEPTH_LEVEL[target[i]],
            bank=banks[i] if p.load_seqs else None,
            moves=moves[i], internal_edges=p.internal_edges,
            added_loads=p.added_loads, memval_leaves=p.memval_leaves,
            dram_fills=fills[i]))
    return out


def _place(part: SelectionPartition, ct: ColumnarTrace,
           cfg: OffloadConfig) -> List[Candidate]:
    """Placement: levels, moves, banks, DRAM fills per proto, on the
    trace's device (``accel.place``: the placement kernel on a CUDA trace,
    its plain version on a CPU trace)."""
    return place_candidates(part, ct, cfg)


# ======================================================================
# Analysis bundle + entry points
# ======================================================================
class TraceAnalysis:
    """Config-independent artifacts of one traced workload: the builder and
    flow index, shared through the structural trace's memo so geometry
    variants of one workload reuse them."""

    def __init__(self, trace: ColumnarTrace,
                 builder: Optional[IDGBuilder] = None,
                 flow: Optional[FlowIndex] = None):
        self.trace = trace
        self.builder = builder or IDGBuilder(trace)
        self.flow = flow if flow is not None else build_flow_index(trace)

    def select(self, cfg: OffloadConfig = OffloadConfig()) -> OffloadResult:
        """Run Algorithm 1 against these artifacts for one configuration."""
        return select_candidates(self.trace, cfg, flow=self.flow,
                                 builder=self.builder,
                                 device=self.trace.device)


def analyze_trace(tr) -> TraceAnalysis:
    """Build the reusable IDG/flow artifacts for a ``TraceResult``."""
    return TraceAnalysis(tr.trace)


def select_candidates(trace: ColumnarTrace,
                      cfg: OffloadConfig = OffloadConfig(),
                      flow: Optional[FlowIndex] = None,
                      builder: Optional[IDGBuilder] = None,
                      device="cuda") -> OffloadResult:
    """Algorithm 1: build tables -> build IDG trees -> partition/extract.

    Runs on ``device`` (the trace moves there if it lives elsewhere)."""
    if not isinstance(trace, ColumnarTrace):
        raise NotImplementedError(_SINGLE_PASS)
    if not cfg.allow_cross_level or cfg.require_same_bank:
        raise NotImplementedError(_SINGLE_PASS)
    moved = trace.to(resolve_device(device))
    if moved is not trace:
        trace, flow, builder = moved, None, None
    builder = builder or IDGBuilder(trace)
    flow = flow or build_flow_index(trace)
    part = _partition(trace, builder, flow, cfg)
    return OffloadResult(_place(part, trace, cfg), part.claimed, flow, cfg)
