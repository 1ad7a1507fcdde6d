"""System profiler — the paper's modified-McPAT stage (§V-C).

Combines the application model (the CIQ from the trace VM), the reshaped
trace, the device/CiM array model (Table III / Fig. 11) and the host model
into whole-system energy + performance for the baseline (non-CiM) and the
CiM-enabled system, and emits the paper's reported metrics: energy
improvement, speedup, processor/cache contribution breakdown (Table VI) and
MACR (Fig. 13).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np

from cimbench.ref.cache import CacheConfig, CacheHierarchy
from cimbench.ref.columnar import ColumnarTrace
from cimbench.ref.device_model import (DRAM_ACCESS_PJ, DRAM_LATENCY_CYCLES,
                                     TechModel, TECHS)
from cimbench.ref.host_model import DEFAULT_HOST, HostModel
from cimbench.ref.isa import (LEVELS, LEVEL_L2, LEVEL_MEM, OP_STORE, UNITS,
                            Trace)
from cimbench.ref.offload import OffloadConfig, OffloadResult, select_candidates
from cimbench.ref.reshape import ReshapedTrace, reshape
from cimbench.ref.trace import TraceResult


@dataclasses.dataclass
class EnergyBreakdown:
    host_pipeline: float = 0.0          # pJ
    host_units: float = 0.0
    host_static: float = 0.0            # static/clock energy over the runtime
    cache: Dict[str, float] = dataclasses.field(default_factory=dict)
    cim: Dict[str, float] = dataclasses.field(default_factory=dict)
    dram: float = 0.0

    @property
    def processor(self) -> float:
        return self.host_pipeline + self.host_units + self.host_static

    @property
    def caches(self) -> float:
        return sum(self.cache.values()) + sum(self.cim.values())

    @property
    def total(self) -> float:
        """Paper scope (SVI-B): 'total energy including both host CPU and
        cache' — main-memory energy is reported separately in `dram`."""
        return self.processor + self.caches

    @property
    def total_with_dram(self) -> float:
        return self.total + self.dram


@dataclasses.dataclass
class SystemReport:
    """Everything Table VI / Figs. 12-16 need for one (program, config)."""
    base: EnergyBreakdown
    cim: EnergyBreakdown
    base_cycles: float
    cim_cycles: float
    macr: float
    macr_l1: float
    macr_other: float
    n_instructions: int
    n_mem_accesses: int
    n_candidates: int
    n_cim_ops: int
    n_offloaded: int
    tech: str

    @property
    def energy_improvement(self) -> float:
        return self.base.total / max(self.cim.total, 1e-9)

    @property
    def speedup(self) -> float:
        return self.base_cycles / max(self.cim_cycles, 1e-9)

    @property
    def processor_ratio(self) -> float:
        """Table VI row 4: share of the energy delta from the processor."""
        delta = self.base.total - self.cim.total
        if abs(delta) < 1e-12:
            return 0.0
        return (self.base.processor - self.cim.processor) / delta

    @property
    def cache_ratio(self) -> float:
        """Table VI row 5 (can be negative: CiM ops cost more than the
        array accesses they replace)."""
        delta = self.base.total - self.cim.total
        if abs(delta) < 1e-12:
            return 0.0
        return ((self.base.caches + self.base.dram)
                - (self.cim.caches + self.cim.dram)) / delta

    @property
    def cim_favorable(self) -> bool:
        """Paper §VI-C: MACR >= ~50% indicates a CiM-favorable program."""
        return self.macr >= 0.5

    def summary(self) -> Dict[str, float]:
        return {
            "energy_improvement": round(self.energy_improvement, 3),
            "speedup": round(self.speedup, 3),
            "macr": round(self.macr, 4),
            "processor_ratio": round(self.processor_ratio, 3),
            "cache_ratio": round(self.cache_ratio, 3),
            "base_energy_nj": round(self.base.total / 1e3, 3),
            "cim_energy_nj": round(self.cim.total / 1e3, 3),
            "n_instructions": self.n_instructions,
            "n_cim_ops": self.n_cim_ops,
        }


class Profiler:
    def __init__(self, cache_levels: Tuple[CacheConfig, ...],
                 tech: str = "sram", host: HostModel = DEFAULT_HOST,
                 float_type=float):
        self.levels = {c.name: c for c in cache_levels}
        # every sum and product below is rounded through float_type:
        # ``float`` (float64) is the original's arithmetic; ``np.float32``
        # gives the benchmark's lower-precision control
        self.ft = float_type
        self.tech_name = tech
        self.tech: TechModel = TECHS[tech]
        self.host = host

    # ----------------------------------------------------- per-access costs
    def _access_energy(self, level: str, is_write: bool) -> float:
        """Array energy for one host access served at ``level``.

        Every access probes L1; deeper services add the deeper array and —
        for DRAM — the line transfer.  (Fill writes are folded into the
        service-level access; documented surrogate.)
        """
        ft = self.ft
        op = "write" if is_write else "read"
        e = self.tech.energy(op, self.levels["L1"])
        if level in ("L2", "MEM") and "L2" in self.levels:
            e = ft(e + (self.tech.energy(op, self.levels["L2"])))
        if level == "MEM":
            e = ft(e + (DRAM_ACCESS_PJ))
        return e

    # -------------------------------------------- vectorized accumulation
    def _price_host_columns(self, eb: EnergyBreakdown, unit_counts,
                            mem_counts) -> float:
        """Shared host-side pricing from per-unit / per-(level, rw) counts.

        ``unit_counts`` is a bincount over functional-unit codes;
        ``mem_counts`` maps (level code, is_write) -> accesses.  One
        multiply per distinct (unit | level x r/w) bucket replaces the
        per-instruction loop — same constants, same totals.
        """
        ft = self.ft
        host = self.host
        n = int(unit_counts.sum())
        eb.host_pipeline = ft(eb.host_pipeline + (n * host.pipeline_pj))
        unit_pj = host.unit_pj
        for code, cnt in enumerate(unit_counts.tolist()):
            if cnt:
                eb.host_units = ft(eb.host_units + (cnt * unit_pj.get(UNITS[code], 15.0)))
        cycles = ft(n * host.base_cpi)
        for (lvl_code, is_wr), cnt in mem_counts.items():
            level = LEVELS[lvl_code]
            e = self._access_energy(level, bool(is_wr))
            if lvl_code == LEVEL_MEM:
                eb.dram = ft(eb.dram + (cnt * DRAM_ACCESS_PJ))
                e = ft(e - (DRAM_ACCESS_PJ))
                cycles = ft(cycles + (cnt * host.mem_stall * host.overlap))
            elif lvl_code == LEVEL_L2:
                cycles = ft(cycles + (cnt * host.l2_stall * host.overlap))
            key = level if level != "MEM" else "L2" \
                if "L2" in self.levels else "L1"
            eb.cache[key] = ft(eb.cache.get(key, 0.0) + cnt * e)
        return cycles

    @staticmethod
    def _mem_counts(level_col, is_store_col) -> Dict[Tuple[int, int], int]:
        """(level code, is_write) -> count over the memory instructions."""
        mem = level_col > 0
        if not mem.any():
            return {}
        combo = level_col[mem].astype(np.int64) * 2 \
            + is_store_col[mem].astype(np.int64)
        counts = np.bincount(combo)
        return {(int(c) // 2, int(c) % 2): int(n)
                for c, n in enumerate(counts) if n}

    # ------------------------------------------------------------ baseline
    def price_baseline(self, trace: Trace) -> Tuple[EnergyBreakdown, float]:
        ft = self.ft
        eb = EnergyBreakdown()
        if isinstance(trace, ColumnarTrace):
            unit_counts = np.bincount(trace.unit, minlength=len(UNITS))
            mem_counts = self._mem_counts(trace.level, trace.op == OP_STORE)
            cycles = ft(self._price_host_columns(eb, unit_counts, mem_counts))
            eb.host_static = ft(self.host.static_pj_per_cycle * cycles)
            return eb, cycles
        cycles = ft(0.0)
        for inst in trace:
            eb.host_pipeline = ft(eb.host_pipeline + (self.host.pipeline_pj))
            eb.host_units = ft(eb.host_units + (self.host.unit_pj.get(inst.unit, 15.0)))
            if inst.is_mem:
                e = self._access_energy(inst.level, inst.is_store)
                if inst.level == "MEM":
                    eb.dram = ft(eb.dram + (DRAM_ACCESS_PJ))
                    e = ft(e - (DRAM_ACCESS_PJ))
                key = inst.level if inst.level != "MEM" else "L2" \
                    if "L2" in self.levels else "L1"
                eb.cache[key] = ft(eb.cache.get(key, 0.0) + e)
            cycles = ft(cycles + (self.host.inst_cycles(inst)))
        eb.host_static = ft(self.host.static_pj_per_cycle * cycles)
        return eb, cycles

    # ------------------------------------------------------------ CiM run
    def price_cim(self, trace: Trace, reshaped: ReshapedTrace
                  ) -> Tuple[EnergyBreakdown, float]:
        ft = self.ft
        eb = EnergyBreakdown()
        if isinstance(trace, ColumnarTrace):
            hs = np.asarray(reshaped.host_seqs, np.int64)
            unit_counts = (np.bincount(trace.unit[hs], minlength=len(UNITS))
                           if len(hs) else np.zeros(len(UNITS), np.int64))
            mem_counts = (self._mem_counts(trace.level[hs],
                                           trace.op[hs] == OP_STORE)
                          if len(hs) else {})
            cycles = ft(self._price_host_columns(eb, unit_counts, mem_counts))
        else:
            cycles = ft(0.0)
            for seq in reshaped.host_seqs:
                inst = trace[seq]
                eb.host_pipeline = ft(eb.host_pipeline + (self.host.pipeline_pj))
                eb.host_units = ft(eb.host_units + (self.host.unit_pj.get(inst.unit, 15.0)))
                if inst.is_mem:
                    e = self._access_energy(inst.level, inst.is_store)
                    if inst.level == "MEM":
                        eb.dram = ft(eb.dram + (DRAM_ACCESS_PJ))
                        e = ft(e - (DRAM_ACCESS_PJ))
                    key = inst.level if inst.level != "MEM" else "L2" \
                        if "L2" in self.levels else "L1"
                    eb.cache[key] = ft(eb.cache.get(key, 0.0) + e)
                cycles = ft(cycles + (self.host.inst_cycles(inst)))

        l1_read_lat = self.tech.latency("read", "L1")
        # one CiM macro-instruction issued/committed by the host per
        # candidate; the array pipelines its op sequence back-to-back.
        # Aggregated: host issue cost per group, array energy/occupancy per
        # (level, op class) bucket — the counts replace the per-op loop.
        n_groups = len(reshaped.cim_groups)
        eb.host_pipeline = ft(eb.host_pipeline + (n_groups * self.host.pipeline_pj))
        cycles = ft(cycles + (n_groups * self.host.base_cpi))
        cls_counts: Counter = Counter()
        for grp in reshaped.cim_groups:
            for cls in grp.op_classes:
                cls_counts[(grp.level, cls)] += 1
        for (level, cls), cnt in cls_counts.items():
            lvl_cfg = self.levels[level]
            eb.cim[level] = ft(eb.cim.get(level, 0.0) +
                               cnt * self.tech.energy(cls, lvl_cfg))
            lat = self.tech.latency(cls, level)
            cycles = ft(cycles + cnt * (self.host.cim_occupancy +
                                        self.host.cim_overlap
                                        * max(0.0, lat - l1_read_lat)))

        for level, n in reshaped.moves.items():          # cross-level writebacks
            cfg = self.levels[level]
            eb.cim[level] = ft(eb.cim.get(level, 0.0) + n * self.tech.energy("write", cfg))
            cycles = ft(cycles + (n * self.host.overlap * self.tech.latency("write", level)))
        for level, n in reshaped.internal_moves.items():  # in-bank merges
            cfg = self.levels[level]
            eb.cim[level] = ft(eb.cim.get(level, 0.0) + n * self.tech.energy("CiM-OR", cfg))
            cycles = ft(cycles + (n * self.host.overlap))
        # DRAM fills survive offloading: the operand's line still has to
        # reach the CiM-capable array (same fill as the baseline's miss path)
        if reshaped.dram_fills:
            n = reshaped.dram_fills
            eb.dram = ft(eb.dram + (n * DRAM_ACCESS_PJ))
            fill_level = "L2" if "L2" in self.levels else "L1"
            eb.cache[fill_level] = ft(
                eb.cache.get(fill_level, 0.0)
                + n * self.tech.energy("write", self.levels[fill_level]))
            cycles = ft(cycles + (n * self.host.mem_stall * self.host.overlap))
        for level, n in reshaped.added_loads.items():     # re-materialized reads
            eb.host_pipeline = ft(eb.host_pipeline + (n * self.host.pipeline_pj))
            eb.host_units = ft(eb.host_units + (n * self.host.unit_pj.get("MemRead", 20.0)))
            eb.cache[level] = ft(eb.cache.get(level, 0.0)
                                 + n * self._access_energy(level, False))
            cycles = ft(cycles + n * (self.host.base_cpi +
                                      (self.host.l2_stall * self.host.overlap
                                       if level == "L2" else 0.0)))
        eb.host_static = ft(self.host.static_pj_per_cycle * cycles)
        return eb, cycles


# ======================================================================
# One-call pipeline: trace -> select -> reshape -> profile
# ======================================================================
def profile_system(tr: TraceResult,
                   offload_cfg: OffloadConfig = OffloadConfig(),
                   tech: str = "sram",
                   host: HostModel = DEFAULT_HOST,
                   offload: Optional[OffloadResult] = None,
                   reshaped: Optional[ReshapedTrace] = None,
                   float_type=float) -> SystemReport:
    """Price one (program, configuration) pair.

    ``offload`` / ``reshaped`` let callers reuse the config-independent
    analysis artifacts (see :func:`cimbench.ref.offload.analyze_trace` and the
    sweep engine in the DSE engine): passing them skips candidate
    selection and trace reshaping, leaving only the cheap pricing phase.
    """
    trace = tr.trace
    cache_cfgs = tuple(lv.cfg for lv in tr.cache.levels)
    if offload is not None:
        result = offload
    elif isinstance(trace, ColumnarTrace):
        # columnar traces carry their own derived tables — never force the
        # legacy RUT/IHT dict views just to pass them through
        result = select_candidates(trace, cfg=offload_cfg)
    else:
        result = select_candidates(trace, tr.rut, tr.iht, offload_cfg)
    reshaped = reshaped or reshape(trace, result)
    prof = Profiler(cache_cfgs, tech=tech, host=host, float_type=float_type)
    base_eb, base_cycles = prof.price_baseline(trace)
    cim_eb, cim_cycles = prof.price_cim(trace, reshaped)
    mb = result.macr_breakdown(trace)
    return SystemReport(
        base=base_eb, cim=cim_eb,
        base_cycles=base_cycles, cim_cycles=cim_cycles,
        macr=mb["macr"], macr_l1=mb["l1"], macr_other=mb["other"],
        n_instructions=len(trace),
        n_mem_accesses=int(mb["total_accesses"]),
        n_candidates=len(result.candidates),
        n_cim_ops=reshaped.n_cim_ops,
        n_offloaded=reshaped.n_offloaded,
        tech=tech,
    )
