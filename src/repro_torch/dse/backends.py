"""Pluggable analysis backends — the analyze → select → price split as an API.

Twin of ``repro/dse/backends.py``, CiM half:

  :class:`AnalysisBackend`   — the protocol: ``analyze`` (layer 1, once per
  analysis key), ``select`` (layer 2, once per hardware/threshold config),
  ``price`` (per point, never cached), composed by ``evaluate``;

  :class:`CimBackend`        — the paper's pipeline: the replayed trace and
  IDG/flow tables via the :class:`~repro_torch.dse.engine.AnalysisCache`
  CiM layers, Algorithm-1 candidate selection, ``profile_system`` pricing;
  or, with a ``sampling`` spec, the sampled pipeline
  (:mod:`repro_torch.core.sampling.pipeline`).

The TPU-mode backend (``TpuBackend``, ``arch_fingerprint``,
``TpuSelection``, ``TpuWorkloadAnalysis``) waits for ROADMAP Queue 1 item
8, which gives :class:`AnalysisBackend` its second implementation.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.core.host_model import HostModel
from repro_torch.core.profiler import profile_system
from repro_torch.core.sampling.spec import SAMPLING_VERSION, SamplingSpec
from repro_torch.core.trace import TRACE_VM_VERSION
from repro_torch.dse.results import SweepRecord
from repro_torch.dse.space import CacheOption, HostOption, SweepPoint
from repro_torch.dse.store import NAMESPACE, workload_fingerprint


class AnalysisBackend(abc.ABC):
    """One pipeline behind the engine: analyze → select → price.

    ==========  ==============================  ===========================
    phase       memoized by                     CiM incarnation
    ==========  ==============================  ===========================
    analyze     layer 1 (workload + geometry)   replayed trace + IDG/flow
    select      layer 2 (+ per-config knobs)    Algorithm 1 + reshape
    price       never (cheap, fanned out)       profile_system
    ==========  ==============================  ===========================

    Backends are small frozen dataclasses: picklable (they ride to
    ``executor="process"`` workers) and stateless — all memoization lives
    in the :class:`~repro_torch.dse.engine.AnalysisCache` they are handed,
    all persistence in the :class:`~repro_torch.dse.store.AnalysisStore`
    behind it.
    """

    name: str = "abstract"

    # ------------------------------------------------------------- phases
    @abc.abstractmethod
    def analyze(self, cache, point: SweepPoint) -> Any:
        """Layer-1 artifact for ``point`` (built once per analysis key)."""

    @abc.abstractmethod
    def select(self, cache, point: SweepPoint, analysis: Any) -> Any:
        """Layer-2 artifact (built once per selection-relevant config)."""

    @abc.abstractmethod
    def price(self, point: SweepPoint, analysis: Any, selection: Any,
              host: HostModel) -> SweepRecord:
        """One priced record — pure function of the two artifacts."""

    # ---------------------------------------------------------- composite
    def evaluate(self, cache, point: SweepPoint,
                 host: HostModel) -> SweepRecord:
        if obs.tracer() is None:           # keep the untraced path bare
            analysis = self.analyze(cache, point)
            selection = self.select(cache, point, analysis)
            return self.price(point, analysis, selection, host)
        with obs.span("backend.evaluate", cat="engine", backend=self.name,
                      workload=point.workload, point=point.label):
            with obs.span("backend.analyze", cat="analysis",
                          backend=self.name, workload=point.workload):
                analysis = self.analyze(cache, point)
            with obs.span("backend.select", cat="select",
                          backend=self.name, workload=point.workload):
                selection = self.select(cache, point, analysis)
            with obs.span("backend.price", cat="price", backend=self.name,
                          workload=point.workload):
                return self.price(point, analysis, selection, host)

    def warm_many(self, cache, points: Sequence[SweepPoint]) -> None:
        """Build the layer-1 artifact of one representative point per
        analysis key ahead of the pricing fan-out.  The engine hands over
        the whole key set at once so backends can batch across it; the
        default is the serial per-key warm."""
        for p in points:
            self.analyze(cache, p)


@dataclasses.dataclass(frozen=True)
class CimBackend(AnalysisBackend):
    """Eva-CiM's trace → Algorithm-1 selection → McPAT/DESTINY pricing.

    The layer-1/2 memo logic (with the persistent store and its version
    stamps) lives in :class:`~repro_torch.dse.engine.AnalysisCache`; the
    layer-1 artifact is a columnar
    :class:`~repro_torch.core.trace.TraceResult`, so ``analyze`` per
    (workload, geometry) costs one access-stream replay and ``price`` is a
    column scan.

    ``sampling`` (default exact) swaps the whole pipeline for its sampled
    counterpart (:mod:`repro_torch.core.sampling.pipeline`): ``analyze``
    becomes skim → plan → windowed trace (persisted once per (workload,
    sampling key), independent of geometry) plus one warm-chained replay
    per geometry (one replay-kernel launch on the card), ``select`` runs
    Algorithm 1 per sampled window (one placement-kernel launch per
    window), and ``price`` returns the cluster-weighted estimate with
    bootstrap CI columns.  Exact mode touches none of the sampled code
    paths — records, counters, and cache keys are the pre-sampling ones.
    """

    sampling: SamplingSpec = SamplingSpec()

    name = "cim"

    @property
    def variant(self) -> Optional[str]:
        """Memo-key discriminator for engines that share one cache across
        differently-configured backends: ``None`` for exact (the
        pre-sampling identity), else the sampling key."""
        return None if self.sampling.is_exact else self.sampling.key()

    def analyze(self, cache, point: SweepPoint):
        if self.sampling.is_exact:
            return cache.trace(point.workload, point.cache)
        return self._sampled_analysis(cache, point, self.sampling)

    def warm_many(self, cache, points: Sequence[SweepPoint]) -> None:
        """Batch the warm pass per workload: every cache geometry of one
        workload replays in one launch of the replay kernel
        (:meth:`AnalysisCache.replay_group`).  The reference batches only
        under ``EVA_CIM_ACCEL=jax``; in the port the device of the tensors
        chooses between the kernel and its plain version, and the exact
        warm path always batches.  Sampled backends take the serial path —
        the skim/window pass, not the replay, dominates, and it runs once
        per workload either way."""
        if not self.sampling.is_exact:
            super().warm_many(cache, points)
            return
        by_wl: Dict[str, List[CacheOption]] = {}
        for p in points:
            by_wl.setdefault(p.workload, []).append(p.cache)
        for wl, caches in by_wl.items():
            cache.replay_group(wl, caches)

    def select(self, cache, point: SweepPoint, analysis):
        if self.sampling.is_exact:
            return cache.offload(point.workload, point.cache,
                                 point.offload_config())
        from repro_torch.core.sampling import pipeline as spl
        cfg = point.offload_config()
        return cache.artifact(
            2, ("cim.sampled", point.workload, self.sampling.key(),
                point.cache.levels, cfg),
            lambda: spl.select_sampled(analysis, cfg))

    def price(self, point: SweepPoint, analysis, selection,
              host: HostModel) -> SweepRecord:
        if point.host is not None:               # host axis: point overrides
            host = point.host.model
            name = point.host.name
        else:
            # collision-safe label for a custom engine-default model too
            name = HostOption.of(host).name
        if not self.sampling.is_exact:
            from repro_torch.core.sampling import pipeline as spl
            est = spl.price_sampled(analysis, selection, self.sampling,
                                    tech=point.tech, host=host)
            return self._record_from_estimate(point, est, host, name)
        result, reshaped = selection
        rep = profile_system(analysis, tech=point.tech, host=host,
                             offload=result, reshaped=reshaped,
                             device=analysis.trace.device)
        return SweepRecord.from_report(point, rep, host=host, host_name=name)

    # ------------------------------------------------------- sampled path
    def _sampled_structural(self, cache, workload: str, spec: SamplingSpec):
        from repro_torch.core.sampling import pipeline as spl
        skey = spec.key()
        base = workload.partition("@")[0]
        return cache.artifact(
            1, ("cim.sampled", workload, skey),
            lambda: spl.sampled_structural(workload, spec),
            store_spec={"backend": f"{NAMESPACE}.sampled",
                        "version": TRACE_VM_VERSION,
                        "sampling_version": SAMPLING_VERSION,
                        "workload": workload,
                        "fingerprint": workload_fingerprint(base),
                        "sampling": skey})

    def _sampled_analysis(self, cache, point: SweepPoint,
                          spec: SamplingSpec):
        from repro_torch.core.sampling import pipeline as spl
        ss = self._sampled_structural(cache, point.workload, spec)
        # per-geometry replay is memo-only: cheap to rebuild, and the
        # artifact holds tensors on the cache's device
        return cache.artifact(
            1, ("cim.sampled.geo", point.workload, spec.key(),
                point.cache.levels),
            lambda: spl.attach_sampled(ss, point.cache.levels,
                                       device=cache.device))

    def _record_from_estimate(self, point: SweepPoint, est, host: HostModel,
                              host_name: str) -> SweepRecord:
        t, m, ci = est.totals, est.metrics, est.ci
        return SweepRecord(
            index=point.index, workload=point.workload,
            cache=point.cache.name,
            cim_levels="+".join(point.cim_levels),
            tech=point.tech, cim_set=point.cim_set, host=host_name,
            energy_improvement=m["energy_improvement"],
            speedup=m["speedup"], macr=m["macr"], macr_l1=m["macr_l1"],
            base_energy_pj=t["base_energy"], cim_energy_pj=t["cim_energy"],
            base_cycles=t["base_cycles"], cim_cycles=t["cim_cycles"],
            base_runtime_ms=host.runtime_ms(t["base_cycles"]),
            cim_runtime_ms=host.runtime_ms(t["cim_cycles"]),
            processor_ratio=m["processor_ratio"],
            cache_ratio=m["cache_ratio"],
            n_instructions=int(round(t["n_instructions"])),
            n_mem_accesses=int(round(t["mem_accesses"])),
            n_candidates=int(round(t["n_candidates"])),
            n_cim_ops=int(round(t["n_cim_ops"])),
            backend=self.name, sampling=self.sampling.key(),
            energy_improvement_ci=ci["energy_improvement"],
            speedup_ci=ci["speedup"], macr_ci=ci["macr"])

    def evaluate(self, cache, point: SweepPoint,
                 host: HostModel) -> SweepRecord:
        rec = super().evaluate(cache, point, host)
        spec = self.sampling
        if spec.is_exact or not spec.target_ci:
            return rec
        # CI-driven refinement: double the window budget (<= 3 times)
        # until the energy estimate's relative CI half-width meets the
        # target.  Each refined spec has its own cache identity, so
        # re-evaluations of the same point converge to cache hits.
        for _ in range(3):
            rel = (rec.energy_improvement_ci
                   / max(abs(rec.energy_improvement), 1e-9))
            if rel <= spec.target_ci:
                break
            spec = dataclasses.replace(spec, budget=spec.budget * 2)
            refined = dataclasses.replace(self, sampling=spec)
            rec = AnalysisBackend.evaluate(refined, cache, point, host)
        return rec
