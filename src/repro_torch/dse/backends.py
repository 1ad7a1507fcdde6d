"""Pluggable analysis backends — the analyze → select → price split as an API.

Twin of ``repro/dse/backends.py``, CiM half:

  :class:`AnalysisBackend`   — the protocol: ``analyze`` (layer 1, once per
  analysis key), ``select`` (layer 2, once per hardware/threshold config),
  ``price`` (per point, never cached), composed by ``evaluate``;

  :class:`CimBackend`        — the paper's pipeline: the replayed trace and
  IDG/flow tables via the :class:`~repro_torch.dse.engine.AnalysisCache`
  CiM layers, Algorithm-1 candidate selection, ``profile_system`` pricing.

Only the exact pipeline is ported: the reference's ``sampling`` knob of
:class:`CimBackend` (the sampled pipeline) waits for ROADMAP Queue 1 item
6, and the TPU-mode backend (``TpuBackend``, ``arch_fingerprint``,
``TpuSelection``, ``TpuWorkloadAnalysis``) for item 8, which gives
:class:`AnalysisBackend` its second implementation.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Sequence

from repro_torch import obs
from repro_torch.core.host_model import HostModel
from repro_torch.core.profiler import profile_system
from repro_torch.dse.results import SweepRecord
from repro_torch.dse.space import CacheOption, HostOption, SweepPoint


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
    column scan.  It prices every point exactly: the reference's
    ``sampling`` field waits for the sampled pipeline.
    """

    name = "cim"

    def analyze(self, cache, point: SweepPoint):
        return cache.trace(point.workload, point.cache)

    def warm_many(self, cache, points: Sequence[SweepPoint]) -> None:
        """Batch the warm pass per workload: every cache geometry of one
        workload replays in one launch of the replay kernel
        (:meth:`AnalysisCache.replay_group`).  The reference batches only
        under ``EVA_CIM_ACCEL=jax``; in the port the device of the tensors
        chooses between the kernel and its plain version, and the warm
        path always batches."""
        by_wl: Dict[str, List[CacheOption]] = {}
        for p in points:
            by_wl.setdefault(p.workload, []).append(p.cache)
        for wl, caches in by_wl.items():
            cache.replay_group(wl, caches)

    def select(self, cache, point: SweepPoint, analysis):
        return cache.offload(point.workload, point.cache,
                             point.offload_config())

    def price(self, point: SweepPoint, analysis, selection,
              host: HostModel) -> SweepRecord:
        if point.host is not None:               # host axis: point overrides
            host = point.host.model
            name = point.host.name
        else:
            # collision-safe label for a custom engine-default model too
            name = HostOption.of(host).name
        result, reshaped = selection
        rep = profile_system(analysis, tech=point.tech, host=host,
                             offload=result, reshaped=reshaped,
                             device=analysis.trace.device)
        return SweepRecord.from_report(point, rep, host=host, host_name=name)
