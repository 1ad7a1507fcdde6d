"""The geometry-independent trace and its per-geometry replay.

Copied from the original package's ``core/trace.py`` (its public half:
``StructuralTrace``, ``TraceResult``, ``attach_cache_results_batch``),
with the replay always taken by the OrderedDict machine
(:meth:`cimbench.ref.cache.CacheHierarchy.replay`), and a loader for the
committed structural traces under ``traces/``: the original VM's columns
of the 17 Table-IV programs (``ColumnarTrace.to_arrays()`` and the
program outputs).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cimbench.ref.cache import CacheConfig, CacheHierarchy
from cimbench.ref.columnar import ColumnarTrace
from cimbench.ref.isa import OP_STORE

TRACE_DIR = pathlib.Path(__file__).resolve().parent / "traces"


@dataclasses.dataclass
class StructuralTrace:
    """The structural columns of one program plus its concrete outputs."""
    columns: ColumnarTrace
    outputs: List[np.ndarray]

    @property
    def n_instructions(self) -> int:
        return len(self.columns)


class TraceResult:
    """One (program, cache geometry) pair: the columns with the memory
    responses filled, and the replayed hierarchy (for its counters)."""

    __slots__ = ("trace", "cache", "outputs", "structural")

    def __init__(self, trace: ColumnarTrace, cache: CacheHierarchy,
                 outputs: List[np.ndarray],
                 structural: Optional[StructuralTrace] = None):
        self.trace = trace
        self.cache = cache
        self.outputs = outputs
        self.structural = structural

    @property
    def n_instructions(self) -> int:
        return len(self.trace)

    def mem_accesses(self) -> int:
        return self.trace.mem_accesses()


def load_structural(name: str) -> StructuralTrace:
    """The committed structural trace of Table-IV program ``name``."""
    path = TRACE_DIR / f"{name}.npz"
    with np.load(path) as z:
        arrays: Dict[str, np.ndarray] = {k: z[k] for k in z.files}
    n_out = int(arrays["meta_n_outputs"][0])
    return StructuralTrace(ColumnarTrace.from_arrays(arrays),
                           [arrays[f"out_{i}"] for i in range(n_out)])


def attach_cache_results_batch(st: StructuralTrace,
                               geometries: Sequence[Tuple[CacheConfig, ...]]
                               ) -> List[TraceResult]:
    """Replay one structural trace's memory stream under each geometry,
    filling the level/hit/bank/MSHR columns."""
    ct = st.columns
    mem_idx = np.flatnonzero(ct.mem_mask)
    addrs = ct.addr[mem_idx]
    is_writes = ct.op[mem_idx] == OP_STORE
    out = []
    for cache_levels in geometries:
        hier = CacheHierarchy(cache_levels)
        lvl, hit, bank, mshr = hier.replay(addrs, is_writes)
        level_col = np.zeros(ct.n, np.int8)
        hit_col = np.full(ct.n, -1, np.int8)
        bank_col = np.full(ct.n, -1, np.int16)
        mshr_col = np.zeros(ct.n, bool)
        level_col[mem_idx] = lvl
        hit_col[mem_idx] = hit
        bank_col[mem_idx] = bank
        mshr_col[mem_idx] = mshr
        out.append(TraceResult(ct.with_mem_results(level_col, hit_col,
                                                   bank_col, mshr_col),
                               hier, st.outputs, structural=st))
    return out
