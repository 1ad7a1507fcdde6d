"""Trace results and per-geometry cache attachment.

Twin of ``repro/core/trace.py:1177-1285``.  The trace VM itself (``Machine``,
``TraceInterpreter``, ``trace_structural``) is an interpreter over jaxprs
and waits for the port's trace frontend (ROADMAP Queue 1); until then a
:class:`StructuralTrace` comes from the committed trace fixtures
(:func:`repro_torch.workloads.fixtures.load_structural`) or from a
reference trace through :meth:`ColumnarTrace.from_arrays`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cache import (CacheConfig, CacheHierarchy, L1_32K,
                                    L2_256K)
from repro_torch.core.columnar import ColumnarTrace, resolve_device
from repro_torch.core.isa import OP_STORE

# The reference trace VM's lowering version.  The port consumes traces of
# exactly this version; the fixtures record it.
TRACE_VM_VERSION = 2


@dataclasses.dataclass
class StructuralTrace:
    """Geometry-independent half of a traced program: the structural
    columns plus the program's concrete outputs.  One of these exists per
    workload; :func:`attach_cache_results` replays its memory stream
    through a cache hierarchy to produce the per-geometry
    :class:`TraceResult`."""
    columns: ColumnarTrace
    outputs: List[torch.Tensor]

    @property
    def n_instructions(self) -> int:
        return len(self.columns)


class TraceResult:
    """One traced (program, cache geometry) pair: the columnar CIQ with
    memory-response columns filled, the hierarchy (for its counters), and
    the program outputs."""

    __slots__ = ("trace", "cache", "outputs", "structural")

    def __init__(self, trace: ColumnarTrace, cache: CacheHierarchy,
                 outputs: List[torch.Tensor],
                 structural: Optional[StructuralTrace] = None):
        self.trace = trace
        self.cache = cache
        self.outputs = outputs
        self.structural = structural

    @property
    def rut(self) -> Dict[int, List[int]]:
        return self.trace.rut

    @property
    def iht(self) -> Dict[int, List[Tuple[int, int]]]:
        return self.trace.iht

    @property
    def n_instructions(self) -> int:
        return len(self.trace)

    def mem_accesses(self) -> int:
        return self.trace.mem_accesses()


def attach_cache_results(st: StructuralTrace,
                         cache_levels: Tuple[CacheConfig, ...] = (L1_32K,
                                                                  L2_256K),
                         device="cuda") -> TraceResult:
    """Replay the structural trace's memory stream through one cache
    hierarchy, producing its level/hit/bank/MSHR columns."""
    return attach_cache_results_batch(st, [cache_levels], device=device)[0]


def attach_cache_results_batch(st: StructuralTrace,
                               geometries: Sequence[Tuple[CacheConfig, ...]],
                               device="cuda") -> List[TraceResult]:
    """Replay one structural trace under many cache geometries on
    ``device``.

    The structural columns are shared; each geometry only gets its own
    level/hit/bank/MSHR columns.  On ``cuda`` every geometry of one depth
    comes out of one launch of the replay kernel; on ``cpu`` the plain
    :meth:`CacheHierarchy.replay` runs per geometry.  Either way each
    result's hierarchy carries the replay's counters with cold sets, like
    the reference's store-rehydration path."""
    from repro_torch.core.accel.replay import replay_columns_batch

    ct = st.columns.to(resolve_device(device))
    mem_idx = torch.nonzero(ct.mem_mask).flatten()
    addrs = ct.addr[mem_idx]
    is_writes = ct.op[mem_idx] == OP_STORE
    batched = replay_columns_batch(addrs, is_writes, list(geometries))
    out = []
    for (lvl, hit, bank, mshr, counters), cache_levels in zip(batched,
                                                              geometries):
        hier = CacheHierarchy(cache_levels)
        hier.restore_counters(counters)
        level_col = torch.zeros(ct.n, dtype=torch.int8, device=ct.device)
        hit_col = torch.full((ct.n,), -1, dtype=torch.int8, device=ct.device)
        bank_col = torch.full((ct.n,), -1, dtype=torch.int16,
                              device=ct.device)
        mshr_col = torch.zeros(ct.n, dtype=torch.bool, device=ct.device)
        level_col[mem_idx] = lvl
        hit_col[mem_idx] = hit
        bank_col[mem_idx] = bank
        mshr_col[mem_idx] = mshr
        out.append(TraceResult(ct.with_mem_results(level_col, hit_col,
                                                   bank_col, mshr_col),
                               hier, st.outputs, structural=st))
    return out
