"""Trace reshaping (paper §IV-C): turn CIQ + accepted candidates into the
profiling-ready instruction mix.

All offloaded host instructions (loads, OP nodes, and the stores absorbed
into CiM writes) leave the host pipeline; each candidate contributes:

  * one CiM operation per OP node, allocated at the cache level where the
    operands reside (`Candidate.level`),
  * `moves` write-backs for operands that lived at a shallower level
    ("write the operand at the higher-level cache back to the lower-level
    cache, and forward its operator to the same level"),
  * `internal_edges` in-bank data moves for dependent subtrees merged from
    the same IDG tree (post-order combine, Fig. 5c),
  * `added_loads` fresh host loads for values whose register consumers
    survive outside the candidate (the value now lives only in the array).

The reshaped trace keeps host instructions as (index-into-CIQ) references —
no copying — and materializes CiM ops as compact records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from cimbench.ref.columnar import ColumnarTrace
from cimbench.ref.isa import Inst, Trace
from cimbench.ref.offload import Candidate, OffloadResult


@dataclasses.dataclass(frozen=True)
class CimGroup:
    """One reshaped candidate == ONE host-issued CiM macro-instruction
    ([35]-style PIM-enabled instruction; the paper's post-order combine
    merges dependent subtrees into 'one in-cache operation').  The array
    then executes ``op_classes`` back-to-back without host involvement."""
    level: str                         # "L1" | "L2"
    op_classes: Tuple[str, ...]        # Table III pricing class per array op


@dataclasses.dataclass
class ReshapedTrace:
    host_seqs: List[int]               # surviving host instructions (CIQ idx)
    cim_groups: List[CimGroup]
    moves: Dict[str, int]              # level -> cross-level writebacks
    internal_moves: Dict[str, int]     # level -> in-bank merge moves
    added_loads: Dict[str, int]        # level -> synthetic host loads
    dram_fills: int                    # line fills from DRAM kept in both runs
    n_offloaded: int                   # host instructions removed

    @property
    def n_cim_ops(self) -> int:
        return sum(len(g.op_classes) for g in self.cim_groups)

    # ``host_seqs`` is most of the trace — a pickled list of Python ints is
    # ~10x the bytes of the packed array (the persistent layer-2 store and
    # process-pool transfers both ship these)
    def __getstate__(self):
        state = self.__dict__.copy()
        state["host_seqs"] = np.asarray(self.host_seqs, np.int32)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.host_seqs = state["host_seqs"].tolist()


def reshape(trace: Trace, result: OffloadResult) -> ReshapedTrace:
    claimed = result.claimed
    if isinstance(trace, ColumnarTrace):
        # surviving host instructions without materializing a single row
        mask = np.ones(len(trace), bool)
        if claimed:
            mask[np.fromiter(claimed, np.int64, len(claimed))] = False
        host_seqs = np.flatnonzero(mask).tolist()
    else:
        host_seqs = [i.seq for i in trace if i.seq not in claimed]
    groups: List[CimGroup] = []
    moves: Dict[str, int] = {}
    internal: Dict[str, int] = {}
    added: Dict[str, int] = {}
    dram_fills = 0
    # post-order is trace order here: candidates are reported in program
    # order and each candidate's ops execute where its data lives.
    for c in result.candidates:
        groups.append(CimGroup(c.level, tuple(c.op_classes)))
        if c.moves:
            moves[c.level] = moves.get(c.level, 0) + c.moves
        if c.internal_edges:
            internal[c.level] = internal.get(c.level, 0) + c.internal_edges
        if c.added_loads:
            added[c.level] = added.get(c.level, 0) + c.added_loads
        dram_fills += c.dram_fills
    return ReshapedTrace(host_seqs, groups, moves, internal, added,
                         dram_fills=dram_fills, n_offloaded=len(claimed))
