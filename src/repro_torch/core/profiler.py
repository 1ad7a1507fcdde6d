"""System profiler — the paper's modified-McPAT stage (§V-C).

Combines the application model (the CIQ from the trace VM), the reshaped
trace, the device/CiM array model (Table III / Fig. 11) and the host model
into whole-system energy + performance for the baseline (non-CiM) and the
CiM-enabled system, and emits the paper's reported metrics: energy
improvement, speedup, processor/cache contribution breakdown (Table VI) and
MACR (Fig. 13).

Twin of ``repro/core/profiler.py``.  On a columnar trace every count a
design point is priced from -- the functional-unit and (level, is_write)
histograms of the baseline and of the CiM run, the memory accesses and the
converted accesses served at L1 -- comes from one
:func:`~repro_torch.core.accel.price_counts.price_counts` call on the
trace's device (one kernel launch and one readback on the card), made
afresh for every point: :class:`PriceCounts`.  Every float64 sum runs on
the host as Python floats in the reference's statement order, including
the iteration order of its dicts and its ``Counter``, so the priced
reports are *exactly* equal to the reference's, not merely close.  A
hand-built ``List[Inst]`` trace is priced as the reference prices it: one
host loop over the instructions, in its order of additions.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.accel import price_counts as pc
from repro_torch.core.cache import CacheConfig
from repro_torch.core.columnar import ColumnarTrace, resolve_device
from repro_torch.core.device_model import DRAM_ACCESS_PJ, TechModel, TECHS
from repro_torch.core.host_model import DEFAULT_HOST, HostModel
from repro_torch.core.isa import LEVELS, LEVEL_L2, LEVEL_MEM, UNITS
from repro_torch.core.offload import (OffloadConfig, OffloadResult,
                                      select_candidates)
from repro_torch.core.reshape import ReshapedTrace, reshape
from repro_torch.core.trace import TraceResult


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
                 tech: str = "sram", host: HostModel = DEFAULT_HOST):
        self.levels = {c.name: c for c in cache_levels}
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
        op = "write" if is_write else "read"
        e = self.tech.energy(op, self.levels["L1"])
        if level in ("L2", "MEM") and "L2" in self.levels:
            e += self.tech.energy(op, self.levels["L2"])
        if level == "MEM":
            e += DRAM_ACCESS_PJ
        return e

    # -------------------------------------------- vectorized accumulation
    def _price_host_columns(self, eb: EnergyBreakdown, unit_counts: List[int],
                            mem_counts) -> float:
        """Shared host-side pricing from per-unit / per-(level, rw) counts.

        ``unit_counts`` is a bincount over functional-unit codes;
        ``mem_counts`` maps (level code, is_write) -> accesses.  One
        multiply per distinct (unit | level x r/w) bucket replaces the
        per-instruction loop — same constants, same totals.
        """
        host = self.host
        n = sum(unit_counts)
        eb.host_pipeline += n * host.pipeline_pj
        unit_pj = host.unit_pj
        for code, cnt in enumerate(unit_counts):
            if cnt:
                eb.host_units += cnt * unit_pj.get(UNITS[code], 15.0)
        cycles = n * host.base_cpi
        for (lvl_code, is_wr), cnt in mem_counts.items():
            level = LEVELS[lvl_code]
            e = self._access_energy(level, bool(is_wr))
            if lvl_code == LEVEL_MEM:
                eb.dram += cnt * DRAM_ACCESS_PJ
                e -= DRAM_ACCESS_PJ
                cycles += cnt * host.mem_stall * host.overlap
            elif lvl_code == LEVEL_L2:
                cycles += cnt * host.l2_stall * host.overlap
            key = level if level != "MEM" else "L2" \
                if "L2" in self.levels else "L1"
            eb.cache[key] = eb.cache.get(key, 0.0) + cnt * e
        return cycles

    def _price_host_rows(self, eb: EnergyBreakdown, insts) -> float:
        """Host-side pricing of ``List[Inst]`` rows, one instruction at a
        time in the reference's order of additions."""
        cycles = 0.0
        for inst in insts:
            eb.host_pipeline += self.host.pipeline_pj
            eb.host_units += self.host.unit_pj.get(inst.unit, 15.0)
            if inst.is_mem:
                e = self._access_energy(inst.level, inst.is_store)
                if inst.level == "MEM":
                    eb.dram += DRAM_ACCESS_PJ
                    e -= DRAM_ACCESS_PJ
                key = inst.level if inst.level != "MEM" else "L2" \
                    if "L2" in self.levels else "L1"
                eb.cache[key] = eb.cache.get(key, 0.0) + e
            cycles += self.host.inst_cycles(inst)
        return cycles

    # ------------------------------------------------------------ baseline
    def price_baseline(self, trace, counts: Optional["PriceCounts"] = None
                       ) -> Tuple[EnergyBreakdown, float]:
        """``counts`` (a columnar trace's, from :func:`count_trace`) saves
        the count call."""
        eb = EnergyBreakdown()
        if isinstance(trace, ColumnarTrace):
            counts = counts or count_trace(trace)
            cycles = self._price_host_columns(eb, counts.units, counts.mem)
        else:
            cycles = self._price_host_rows(eb, trace)
        eb.host_static = self.host.static_pj_per_cycle * cycles
        return eb, cycles

    # ------------------------------------------------------------ CiM run
    def price_cim(self, trace, reshaped: ReshapedTrace,
                  counts: Optional["PriceCounts"] = None
                  ) -> Tuple[EnergyBreakdown, float]:
        """``counts`` (a columnar trace's, counted at
        ``reshaped.host_seqs``) saves the count call."""
        eb = EnergyBreakdown()
        if isinstance(trace, ColumnarTrace):
            counts = counts or count_trace(trace, reshaped.host_seqs)
            cycles = self._price_host_columns(eb, counts.host_units,
                                              counts.host_mem)
        else:
            cycles = self._price_host_rows(
                eb, (trace[seq] for seq in reshaped.host_seqs.tolist()))

        l1_read_lat = self.tech.latency("read", "L1")
        # one CiM macro-instruction issued/committed by the host per
        # candidate; the array pipelines its op sequence back-to-back.
        # Aggregated: host issue cost per group, array energy/occupancy per
        # (level, op class) bucket — the counts replace the per-op loop.
        n_groups = len(reshaped.cim_groups)
        eb.host_pipeline += n_groups * self.host.pipeline_pj
        cycles += n_groups * self.host.base_cpi
        cls_counts: Counter = Counter()
        for grp in reshaped.cim_groups:
            for cls in grp.op_classes:
                cls_counts[(grp.level, cls)] += 1
        for (level, cls), cnt in cls_counts.items():
            lvl_cfg = self.levels[level]
            eb.cim[level] = eb.cim.get(level, 0.0) + \
                cnt * self.tech.energy(cls, lvl_cfg)
            lat = self.tech.latency(cls, level)
            cycles += cnt * (self.host.cim_occupancy +
                             self.host.cim_overlap
                             * max(0.0, lat - l1_read_lat))

        for level, n in reshaped.moves.items():          # cross-level writebacks
            cfg = self.levels[level]
            eb.cim[level] = eb.cim.get(level, 0.0) + n * self.tech.energy("write", cfg)
            cycles += n * self.host.overlap * self.tech.latency("write", level)
        for level, n in reshaped.internal_moves.items():  # in-bank merges
            cfg = self.levels[level]
            eb.cim[level] = eb.cim.get(level, 0.0) + n * self.tech.energy("CiM-OR", cfg)
            cycles += n * self.host.overlap
        # DRAM fills survive offloading: the operand's line still has to
        # reach the CiM-capable array (same fill as the baseline's miss path)
        if reshaped.dram_fills:
            n = reshaped.dram_fills
            eb.dram += n * DRAM_ACCESS_PJ
            fill_level = "L2" if "L2" in self.levels else "L1"
            eb.cache[fill_level] = eb.cache.get(fill_level, 0.0) + \
                n * self.tech.energy("write", self.levels[fill_level])
            cycles += n * self.host.mem_stall * self.host.overlap
        for level, n in reshaped.added_loads.items():     # re-materialized reads
            eb.host_pipeline += n * self.host.pipeline_pj
            eb.host_units += n * self.host.unit_pj.get("MemRead", 20.0)
            eb.cache[level] = eb.cache.get(level, 0.0) + \
                n * self._access_energy(level, False)
            cycles += n * (self.host.base_cpi +
                           (self.host.l2_stall * self.host.overlap
                            if level == "L2" else 0.0))
        eb.host_static = self.host.static_pj_per_cycle * cycles
        return eb, cycles


# ======================================================================
# The counts a columnar point is priced from: one readback
# ======================================================================
@dataclasses.dataclass
class PriceCounts:
    """The integers one columnar design point is priced from, as the
    profiler's host arithmetic takes them: ``units`` a bincount over
    functional-unit codes (at least ``len(UNITS)`` long), ``mem`` (level
    code, is_write) -> accesses in ascending code order without zeros, each
    over all rows and (``host_``) over the rows the CiM run keeps; the
    trace's loads and stores; the converted accesses and those of them
    served at L1."""
    units: List[int]
    mem: Dict[Tuple[int, int], int]
    host_units: List[int]
    host_mem: Dict[Tuple[int, int], int]
    mem_accesses: int
    converted: int
    converted_l1: int

    def macr_breakdown(self) -> Dict[str, float]:
        """:meth:`OffloadResult.macr_breakdown` from the counts."""
        total = max(1, self.mem_accesses)
        if self.converted:
            l1 = self.converted_l1
            other = self.converted - l1
        else:
            l1 = other = 0
        return {"macr": (l1 + other) / total, "l1": l1 / total,
                "other": other / total,
                "total_accesses": total, "converted": l1 + other}


def _unit_list(bins: List[int]) -> List[int]:
    """A unit histogram as ``bincount(minlength=len(UNITS))`` returns it."""
    n = len(bins)
    while n > len(UNITS) and not bins[n - 1]:
        n -= 1
    return bins[:n]


def _mem_dict(bins: List[int]) -> Dict[Tuple[int, int], int]:
    return {(c // 2, c % 2): n for c, n in enumerate(bins) if n}


def count_trace(trace: ColumnarTrace,
                host_seqs: Optional[torch.Tensor] = None,
                conv: Optional[torch.Tensor] = None) -> PriceCounts:
    """The counts of ``trace``, its rows at ``host_seqs`` and the converted
    accesses at ``conv`` (int64 seqs; none where omitted), in one
    :func:`~repro_torch.core.accel.price_counts.price_counts` call on the
    trace's device."""
    dev = trace.device
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    hs = empty if host_seqs is None else host_seqs.to(dev)
    conv = empty if conv is None else conv
    c = pc.price_counts(trace.unit, trace.level, trace.op, hs, conv)
    return PriceCounts(
        units=_unit_list(c[pc.UNITS_ALL:pc.UNITS_HOST]),
        mem=_mem_dict(c[pc.MEM_ALL:pc.MEM_HOST]),
        host_units=_unit_list(c[pc.UNITS_HOST:pc.MEM_ALL]),
        host_mem=_mem_dict(c[pc.MEM_HOST:pc.MEM_ROWS]),
        mem_accesses=c[pc.MEM_ROWS], converted=conv.numel(),
        converted_l1=c[pc.CONV_L1])


def _converted_index(result: OffloadResult, device) -> torch.Tensor:
    """Every candidate's load and store seqs, in candidate order, as one
    int64 tensor on ``device``."""
    return torch.tensor(list(itertools.chain.from_iterable(
        c.load_seqs + c.store_seqs for c in result.candidates)),
        dtype=torch.int64, device=device)


# (id(selection), id(reshaped trace), device) -> (weak references to both,
# (host_seqs, converted index) on the device); an entry leaves when either
# object dies, so an id is never read for another object
_index: Dict[tuple, tuple] = {}
_index_lock = threading.Lock()


def _selection_index(result: OffloadResult, reshaped: ReshapedTrace,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(host_seqs, converted index) of one selection on ``device``, int64:
    built once per selection and reshaped trace object, so the points that
    share a selection (the engine's layer-2 memo hands one object to every
    technology and host) share them too."""
    key = (id(result), id(reshaped), device)
    with _index_lock:
        entry = _index.get(key)
    if entry is not None and entry[0]() is result \
            and entry[1]() is reshaped:
        return entry[2]
    built = (reshaped.host_seqs.to(device=device, dtype=torch.int64)
             .contiguous(), _converted_index(result, device))

    def drop(_ref, key=key):
        _index.pop(key, None)

    with _index_lock:
        _index[key] = (weakref.ref(result, drop),
                       weakref.ref(reshaped, drop), built)
    return built


# ======================================================================
# One-call pipeline: trace -> select -> reshape -> profile
# ======================================================================
def profile_system(tr: TraceResult,
                   offload_cfg: OffloadConfig = OffloadConfig(),
                   tech: str = "sram",
                   host: HostModel = DEFAULT_HOST,
                   offload: Optional[OffloadResult] = None,
                   reshaped: Optional[ReshapedTrace] = None,
                   device="cuda") -> SystemReport:
    """Price one (program, configuration) pair on ``device``.

    ``offload`` / ``reshaped`` let callers reuse the config-independent
    analysis artifacts (see :func:`repro_torch.core.offload.analyze_trace`):
    passing them skips candidate selection and trace reshaping, leaving
    only the cheap pricing phase.  A ``TraceResult`` whose ``trace`` is a
    hand-built ``List[Inst]`` (with its ``rut``/``iht``) is priced on the
    host, as the reference prices it; ``device`` applies to columnar
    traces.
    """
    trace = tr.trace
    cache_cfgs = tuple(lv.cfg for lv in tr.cache.levels)
    if isinstance(trace, ColumnarTrace):
        trace = trace.to(resolve_device(device))
    if offload is not None:
        result = offload
    elif isinstance(trace, ColumnarTrace):
        result = select_candidates(trace, cfg=offload_cfg,
                                   device=trace.device)
    else:
        result = select_candidates(trace, tr.rut, tr.iht, offload_cfg)
    reshaped = reshaped or reshape(trace, result)
    prof = Profiler(cache_cfgs, tech=tech, host=host)
    counts = None
    if isinstance(trace, ColumnarTrace):
        with obs.span("price.counts", cat="price",
                      launches=int(trace.device.type == "cuda")):
            counts = count_trace(trace, *_selection_index(result, reshaped,
                                                          trace.device))
    with obs.span("price.baseline", cat="price"):
        base_eb, base_cycles = prof.price_baseline(trace, counts)
    with obs.span("price.cim", cat="price",
                  n_groups=len(reshaped.cim_groups)):
        cim_eb, cim_cycles = prof.price_cim(trace, reshaped, counts)
    with obs.span("price.macr", cat="price"):
        mb = (result.macr_breakdown(trace) if counts is None
              else counts.macr_breakdown())
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
