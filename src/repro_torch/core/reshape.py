"""Trace reshaping (paper §IV-C): turn CIQ + accepted candidates into the
profiling-ready instruction mix.

Twin of ``repro/core/reshape.py``.  All offloaded host instructions
(loads, OP nodes, and the stores absorbed into CiM writes) leave the host
pipeline; each candidate contributes one CiM operation per OP node at its
offload level, ``moves`` cross-level write-backs, ``internal_edges``
in-bank merges and ``added_loads`` fresh host loads.

The surviving host instructions stay a tensor of CIQ indices on the
trace's device -- the pricing stage gathers the unit and level columns
with it without a round trip through Python.  A hand-built ``List[Inst]``
trace is a host object: its surviving indices are a CPU int64 tensor, so
``host_seqs`` has one type whatever the trace.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.core.columnar import ColumnarTrace
from repro_torch.core.offload import OffloadResult


@dataclasses.dataclass(frozen=True)
class CimGroup:
    """One reshaped candidate == ONE host-issued CiM macro-instruction; the
    array then executes ``op_classes`` back-to-back without the host."""
    level: str                         # "L1" | "L2"
    op_classes: Tuple[str, ...]        # Table III pricing class per array op


@dataclasses.dataclass
class ReshapedTrace:
    host_seqs: torch.Tensor            # surviving host instructions (int64)
    cim_groups: List[CimGroup]
    moves: Dict[str, int]              # level -> cross-level writebacks
    internal_moves: Dict[str, int]     # level -> in-bank merge moves
    added_loads: Dict[str, int]        # level -> synthetic host loads
    dram_fills: int                    # line fills from DRAM kept in both runs
    n_offloaded: int                   # host instructions removed

    @property
    def n_cim_ops(self) -> int:
        return sum(len(g.op_classes) for g in self.cim_groups)

    # ``host_seqs`` pickles as a numpy array and comes back as a CPU
    # tensor, so a pickle never holds a CUDA tensor
    def __getstate__(self):
        state = self.__dict__.copy()
        state["host_seqs"] = self.host_seqs.cpu().numpy()
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.host_seqs = torch.from_numpy(state["host_seqs"])


def reshape(trace, result: OffloadResult) -> ReshapedTrace:
    claimed = result.claimed
    if isinstance(trace, ColumnarTrace):
        mask = torch.ones(len(trace), dtype=torch.bool, device=trace.device)
        if claimed:
            mask[torch.tensor(list(claimed), dtype=torch.int64,
                              device=trace.device)] = False
        host_seqs = torch.nonzero(mask).flatten()
    else:
        host_seqs = torch.tensor([i.seq for i in trace
                                  if i.seq not in claimed],
                                 dtype=torch.int64)
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
