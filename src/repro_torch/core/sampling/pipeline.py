"""The sampled analysis pipeline: skim → plan → windows → replay → price.

Twin of ``repro/core/sampling/pipeline.py``.  Mirrors the exact pipeline's
layering so the :class:`~repro_torch.dse.backends.CimBackend` can cache
each piece at the right granularity:

``sampled_structural``  (layer 1, geometry-independent, persisted)
    One skim pass for features + stream length, one plan, one windowed
    trace pass, all on the host.  Kept as plain numpy arrays
    (:class:`SampledStructural`) so the store blob never pickles live
    tensors or trace objects.

``attach_sampled``  (layer 1, per geometry, memoized)
    ONE cache-hierarchy replay over the whole windowed trace in virtual
    order — windows warm each other exactly as their prefix would have
    (warm chaining) — through
    :func:`~repro_torch.core.trace.attach_cache_results_batch`: on
    ``cuda`` one launch of the replay kernel (K1), on ``cpu`` the plain
    :meth:`~repro_torch.core.cache.CacheHierarchy.replay`.  Then sliced
    back into per-window :class:`~repro_torch.core.trace.TraceResult`
    views.

``select_sampled``  (layer 2, per offload config, memoized)
    Algorithm-1 selection + reshape per window; on ``cuda`` each window's
    placement is one launch of the placement kernel (K4).

``price_sampled``  (never cached)
    Per-window :func:`~repro_torch.core.profiler.profile_system`, then the
    cluster-weighted estimator with bootstrap CIs
    (:mod:`repro_torch.core.sampling.estimate`).

Workload names accept a ``name@scale`` suffix (``"KM@64"``) that routes to
``repro_torch.workloads.build(name, scale)`` — how the benchmark builds the
>=10^6-instruction loop-scaled variants without touching the registry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.cache import CacheConfig, CacheHierarchy
from repro_torch.core.columnar import ColumnarTrace, resolve_device
from repro_torch.core.host_model import DEFAULT_HOST, HostModel
from repro_torch.core.offload import (OffloadConfig, OffloadResult,
                                      analyze_trace)
from repro_torch.core.profiler import profile_system
from repro_torch.core.reshape import ReshapedTrace, reshape
from repro_torch.core.sampling.cluster import SamplePlan, build_plan
from repro_torch.core.sampling.estimate import (SampledEstimate,
                                                estimate_reports)
from repro_torch.core.sampling.machines import (TraceLimits, skim_program,
                                                trace_windows)
from repro_torch.core.sampling.spec import SamplingSpec
from repro_torch.core.trace import (StructuralTrace, TraceResult,
                                    attach_cache_results_batch)


# --------------------------------------------------------------- workloads
def build_workload(name: str):
    """``repro_torch.workloads.build`` with ``name@scale`` syntax support."""
    from repro_torch.workloads import build
    base, _, scale = name.partition("@")
    return build(base, int(scale)) if scale else build(base)


# --------------------------------------------------------------- slicing
def slice_columns(ct: ColumnarTrace, lo: int, hi: int) -> ColumnarTrace:
    """Rows ``[lo, hi)`` as a standalone columnar trace on ``ct``'s device
    (source CSR re-based; fresh ``_struct`` memo — derived tables of a
    window are not the full trace's)."""
    so = ct.src_off
    slo, shi = int(so[lo]), int(so[hi])
    return ColumnarTrace(
        hi - lo, ct.op[lo:hi], ct.unit[lo:hi], ct.dtype[lo:hi],
        ct.dst[lo:hi], ct.addr[lo:hi], ct.size[lo:hi], ct.level[lo:hi],
        ct.hit[lo:hi], ct.bank[lo:hi], ct.mshr[lo:hi],
        so[lo:hi + 1] - slo, ct.src_tag[slo:shi], ct.src_val[slo:shi],
        ct.src_kind[slo:shi], ct.n_regs)


# ----------------------------------------------------------- layer-1 pieces
@dataclasses.dataclass
class SampledStructural:
    """Geometry-independent sampled artifact: the plan plus the windowed
    structural trace (only picklable primitives and numpy arrays — safe as
    a store blob)."""
    workload: str
    spec_key: str
    plan: SamplePlan
    columns: Dict[str, np.ndarray]          # windowed trace, to_arrays form
    marks: Tuple[Tuple[int, int, int], ...]  # (window, row lo, row hi)
    skim_rate: float                        # virtual instrs/s of the skim
    # Indices into ``marks`` that are *measured* windows, one per plan
    # pick in order; the rest are warmup prefixes (traced to prime the
    # register file and cache, never priced).  Empty = every mark is
    # measured (no warmup — e.g. the degenerate full-coverage plan).
    measured: Tuple[int, ...] = ()

    def trace(self, device="cuda") -> ColumnarTrace:
        return ColumnarTrace.from_arrays(self.columns, device=device)

    def measured_marks(self) -> Tuple[Tuple[int, int, int], ...]:
        if not self.measured:
            return self.marks
        return tuple(self.marks[i] for i in self.measured)


def sampled_structural(workload: str, spec: SamplingSpec) -> SampledStructural:
    """Skim + plan + windowed trace for one workload (the expensive,
    geometry-independent pass of sampled analysis, on the host)."""
    fn, args = build_workload(workload)
    with obs.span("sampling.skim", cat="sampling", workload=workload,
                  interval=spec.interval) as sp:
        t0 = time.perf_counter()
        skim = skim_program(fn, *args, interval=spec.interval)
        dt = time.perf_counter() - t0
        rate = skim.total_virtual / max(dt, 1e-9)
        sp.set(virtual=skim.total_virtual, intervals=skim.n_intervals,
               rate=int(rate))
    plan = build_plan(skim, spec)
    # Interleave a warmup prefix [lo - warmup, lo) before each measured
    # window (clamped so it never overlaps the previous window): the
    # windowed machine flows register/cache state across the shared
    # boundary, so the measured window starts with a primed register file
    # instead of a cold one (SMARTS-style detailed warmup).  The full
    # coverage plan is one window from virtual 0 and needs none.
    warm = 0 if plan.full else spec.warmup
    traced: List[Tuple[int, int]] = []
    measured: List[int] = []
    prev_hi = 0
    for lo, hi in plan.windows():
        wlo = max(prev_hi, lo - warm)
        if wlo < lo:
            traced.append((wlo, lo))
        measured.append(len(traced))
        traced.append((lo, hi))
        prev_hi = hi
    with obs.span("sampling.windows", cat="sampling", workload=workload,
                  n_windows=plan.n_windows) as sp:
        wt = trace_windows(fn, *args, windows=traced,
                           limits=TraceLimits(max_instructions=1 << 62),
                           expect_total=skim.total_virtual, device="cpu")
        sp.set(rows=wt.structural.n_instructions,
               warm_windows=len(traced) - len(measured))
    return SampledStructural(
        workload=workload, spec_key=spec.key(), plan=plan,
        columns=wt.structural.columns.to_arrays(),
        marks=tuple(tuple(m) for m in wt.marks), skim_rate=rate,
        measured=tuple(measured) if len(traced) > len(measured) else ())


@dataclasses.dataclass
class SampledAnalysis:
    """Per-geometry sampled artifact: the warm-chained replayed windowed
    trace sliced into per-window results (shared hierarchy for pricing)."""
    structural: SampledStructural
    windows: List[TraceResult]              # one per plan pick, in order
    cache: CacheHierarchy

    @property
    def plan(self) -> SamplePlan:
        return self.structural.plan


def attach_sampled(ss: SampledStructural,
                   cache_levels: Tuple[CacheConfig, ...],
                   device="cuda") -> SampledAnalysis:
    """Replay the whole windowed trace through one hierarchy on ``device``
    (windows warm each other in virtual order), then slice per window.
    The hierarchy carries the replay's configs and counters; pricing reads
    only its configs."""
    dev = resolve_device(device)
    with obs.span("sampling.replay", cat="sampling", workload=ss.workload,
                  n_windows=len(ss.marks)):
        (full,) = attach_cache_results_batch(
            StructuralTrace(ss.trace(dev), []), [tuple(cache_levels)],
            device=dev)
        windows = [
            TraceResult(slice_columns(full.trace, lo, hi), full.cache, [])
            for _, lo, hi in ss.measured_marks()]
    return SampledAnalysis(structural=ss, windows=windows, cache=full.cache)


# ------------------------------------------------------------------ layer 2
def select_sampled(sa: SampledAnalysis, cfg: OffloadConfig
                   ) -> List[Tuple[OffloadResult, ReshapedTrace]]:
    """Algorithm-1 selection + reshape, per sampled window."""
    out = []
    with obs.span("sampling.select", cat="sampling",
                  workload=sa.structural.workload,
                  n_windows=len(sa.windows)):
        for tr in sa.windows:
            analysis = analyze_trace(tr)
            result = analysis.select(cfg)
            out.append((result, reshape(analysis.trace, result)))
    return out


# ------------------------------------------------------------------ pricing
def price_sampled(sa: SampledAnalysis,
                  selections: Sequence[Tuple[OffloadResult, ReshapedTrace]],
                  spec: SamplingSpec, tech: str = "sram",
                  host: Optional[HostModel] = None) -> SampledEstimate:
    """Per-window pricing + the cluster-weighted bootstrap estimator."""
    host = host or DEFAULT_HOST
    with obs.span("sampling.estimate", cat="sampling",
                  workload=sa.structural.workload,
                  n_windows=len(sa.windows)):
        reports = [
            profile_system(tr, tech=tech, host=host,
                           offload=result, reshaped=reshaped,
                           device=tr.trace.device)
            for tr, (result, reshaped) in zip(sa.windows, selections)]
        return estimate_reports(reports, sa.plan, spec)


# ----------------------------------------------------------- one-shot driver
def sampled_report(workload: str, spec: SamplingSpec,
                   cache_levels: Tuple[CacheConfig, ...],
                   cfg: OffloadConfig = OffloadConfig(),
                   tech: str = "sram",
                   host: Optional[HostModel] = None,
                   device="cuda") -> SampledEstimate:
    """The whole sampled pipeline, uncached, replay and selection on
    ``device`` (benchmarks and tests)."""
    ss = sampled_structural(workload, spec)
    sa = attach_sampled(ss, cache_levels, device=device)
    return price_sampled(sa, select_sampled(sa, cfg), spec, tech=tech,
                         host=host)
