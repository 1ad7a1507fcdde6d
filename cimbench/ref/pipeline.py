"""The reference's view of a design point: layer 1, selection and the
priced record, worked out from the committed structural traces.

Design points arrive as the plain dicts of :func:`cimbench.generator.point`;
names, labels and record fields follow the original package's
``dse/space.py`` and ``dse/results.py`` (``CacheOption.of``,
``HostOption.of``, ``SweepRecord.from_report``).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from cimbench.ref.cache import CacheConfig
from cimbench.ref.host_model import DEFAULT_HOST, HOST_PRESETS, HostModel
from cimbench.ref.isa import CIM_SET_FULL, CIM_SET_LOGIC, CIM_SET_STT
from cimbench.ref.offload import OffloadConfig, TraceAnalysis, analyze_trace
from cimbench.ref.profiler import profile_system
from cimbench.ref.reshape import reshape
from cimbench.ref.trace import (StructuralTrace, TraceResult,
                                attach_cache_results_batch, load_structural)

LEVEL_PRESETS = {"L1_only": ("L1",), "L2_only": ("L2",), "both": ("L1", "L2")}
CIM_SETS = {"logic": CIM_SET_LOGIC, "stt": CIM_SET_STT, "full": CIM_SET_FULL}


def levels_of(geometry, banks: int = 4, mshrs: int = 8
              ) -> Tuple[CacheConfig, ...]:
    """``[[l1_kib, l1_ways], [l2_kib, l2_ways]]`` as cache levels."""
    (l1k, l1w), (l2k, l2w) = geometry
    return (CacheConfig("L1", l1k * 1024, l1w, banks, mshrs),
            CacheConfig("L2", l2k * 1024, l2w, banks, mshrs))


def cache_name(levels: Tuple[CacheConfig, ...]) -> str:
    """A geometry's label, as ``CacheOption.of`` names a level tuple."""
    mb = 1024 * 1024

    def size_name(c: CacheConfig) -> str:
        return f"{c.size // mb}M" if c.size >= mb else f"{c.size // 1024}K"

    return "+".join(size_name(c) for c in levels)


def host_model(fields: Optional[Dict]) -> HostModel:
    return DEFAULT_HOST if fields is None else HostModel(**fields)


def host_label(model: HostModel) -> str:
    """A host's record label, as ``HostOption.of`` names a model."""
    return (model.name if HOST_PRESETS.get(model.name) == model
            else f"custom({model.name})")


def candidate_rows(result) -> List[tuple]:
    """Every field of every candidate of a selection, in order."""
    return [(int(c.root_seq), [int(x) for x in c.op_seqs],
             [str(x) for x in c.op_classes], [int(x) for x in c.load_seqs],
             [int(x) for x in c.store_seqs], str(c.level),
             None if c.bank is None else int(c.bank), int(c.moves),
             int(c.internal_edges), int(c.added_loads),
             int(c.memval_leaves), int(c.dram_fills))
            for c in result.candidates]


def reshaped_summary(reshaped) -> tuple:
    """What pricing reads of a reshaped trace: the surviving host
    instructions (as a digest), the CiM groups and the move counts."""
    seqs = np.asarray(reshaped.host_seqs, dtype=np.int64)
    return (hashlib.sha256(seqs.tobytes()).hexdigest(), len(seqs),
            [(str(g.level), tuple(str(c) for c in g.op_classes))
             for g in reshaped.cim_groups],
            {str(k): int(v) for k, v in reshaped.moves.items()},
            {str(k): int(v) for k, v in reshaped.internal_moves.items()},
            {str(k): int(v) for k, v in reshaped.added_loads.items()},
            int(reshaped.dram_fills), int(reshaped.n_offloaded))


class Reference:
    """Layer 1, selections and records of the reference, memoized like the
    engine's layers so a sample shares its replays."""

    def __init__(self, banks: int = 4, mshrs: int = 8):
        self.banks, self.mshrs = banks, mshrs
        self._structural: Dict[str, StructuralTrace] = {}
        self._layer1: Dict[tuple, Tuple[TraceResult, TraceAnalysis]] = {}
        self._selections: Dict[tuple, tuple] = {}

    def levels(self, geometry) -> Tuple[CacheConfig, ...]:
        return levels_of(geometry, self.banks, self.mshrs)

    def structural(self, workload: str) -> StructuralTrace:
        st = self._structural.get(workload)
        if st is None:
            st = self._structural[workload] = load_structural(workload)
        return st

    def layer1(self, workload: str, geometry) -> Tuple[TraceResult,
                                                      TraceAnalysis]:
        key = (workload, self.levels(geometry))
        hit = self._layer1.get(key)
        if hit is None:
            (tr,) = attach_cache_results_batch(self.structural(workload),
                                               [key[1]])
            hit = self._layer1[key] = (tr, analyze_trace(tr))
        return hit

    def replay(self, workload: str, geometry) -> Tuple[Dict[str, np.ndarray],
                                                       Dict[str, int]]:
        """The per-access response columns (memory instructions only) and
        the replay's counters."""
        tr, _ = self.layer1(workload, geometry)
        mem = tr.trace.mem_mask
        return ({"level": tr.trace.level[mem], "hit": tr.trace.hit[mem],
                 "bank": tr.trace.bank[mem], "mshr": tr.trace.mshr[mem]},
                tr.cache.counters())

    def selection(self, workload: str, geometry, cim_levels: str,
                  cim_set: str):
        key = (workload, self.levels(geometry), cim_levels, cim_set)
        hit = self._selections.get(key)
        if hit is None:
            _, an = self.layer1(workload, geometry)
            result = an.select(OffloadConfig(
                cim_set=CIM_SETS[cim_set],
                cim_levels=LEVEL_PRESETS[cim_levels]))
            hit = self._selections[key] = (result, reshape(an.trace, result))
        return hit

    def record(self, point: Dict, index: int, float_type=float) -> Dict:
        """Every field of the exact record of ``point`` at ``index``."""
        tr, _ = self.layer1(point["workload"], point["geometry"])
        result, shaped = self.selection(point["workload"], point["geometry"],
                                        point["cim_levels"],
                                        point["cim_set"])
        host = host_model(point["host"])
        rep = profile_system(tr, tech=point["tech"], host=host,
                             offload=result, reshaped=shaped,
                             float_type=float_type)
        # float() turns a float32 control's numpy scalars into the plain
        # floats the program's records hold
        return {"index": index, "workload": point["workload"],
                "cache": cache_name(self.levels(point["geometry"])),
                "cim_levels": "+".join(LEVEL_PRESETS[point["cim_levels"]]),
                "tech": point["tech"], "cim_set": point["cim_set"],
                "host": host_label(host),
                "energy_improvement": float(rep.energy_improvement),
                "speedup": float(rep.speedup), "macr": float(rep.macr),
                "macr_l1": float(rep.macr_l1), "base_energy_pj": float(rep.base.total),
                "cim_energy_pj": float(rep.cim.total),
                "base_cycles": float(rep.base_cycles), "cim_cycles": float(rep.cim_cycles),
                "base_runtime_ms": float(host.runtime_ms(rep.base_cycles)),
                "cim_runtime_ms": float(host.runtime_ms(rep.cim_cycles)),
                "processor_ratio": float(rep.processor_ratio),
                "cache_ratio": float(rep.cache_ratio),
                "n_instructions": rep.n_instructions,
                "n_mem_accesses": rep.n_mem_accesses,
                "n_candidates": rep.n_candidates, "n_cim_ops": rep.n_cim_ops,
                "round": 0, "backend": "cim"}
