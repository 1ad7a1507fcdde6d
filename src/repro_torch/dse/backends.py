"""Pluggable analysis backends — the analyze → select → price split as an API.

Twin of ``repro/dse/backends.py``:

  :class:`AnalysisBackend`   — the protocol: ``analyze`` (layer 1, once per
  analysis key), ``select`` (layer 2, once per hardware/threshold config),
  ``price`` (per point, never cached), composed by ``evaluate``;

  :class:`CimBackend`        — the paper's pipeline: the replayed trace and
  IDG/flow tables via the :class:`~repro_torch.dse.engine.AnalysisCache`
  CiM layers, Algorithm-1 candidate selection, ``profile_system`` pricing;
  or, with a ``sampling`` spec, the sampled pipeline
  (:mod:`repro_torch.core.sampling.pipeline`);

  :class:`TpuBackend`        — the accelerator-mode adaptation: one graph
  analysis per (workload, shape, seed) — :func:`analyze_train_step`
  records a train step on weights drawn from the seed (an arch id's
  reduced config, or a configuration at its published widths) as an ATen
  graph on the cache's device and runs
  :func:`~repro_torch.core.hlo.fusion_candidates` and
  :func:`~repro_torch.core.hlo_cost.analyze_graph` over it — then
  per-:class:`~repro_torch.dse.space.TpuOption` fusion selection
  (``min_saved_bytes`` threshold + VMEM fit) and roofline/energy pricing
  on a :class:`~repro_torch.core.tpu_model.TpuChip`.  Selection and
  pricing are the reference's line for line; the names are its wire
  vocabulary (the engine's backend ``"tpu"``).

Both run through the same engine, cache, store (layer-1 artifacts of
both persist under the ``cimtorch`` namespace) and adaptive loop.
"""
from __future__ import annotations

import abc
import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core.host_model import HostModel
from repro_torch.core.profiler import profile_system
from repro_torch.core.sampling.spec import SAMPLING_VERSION, SamplingSpec
from repro_torch.core.tpu_model import roofline_terms, step_energy_pj
from repro_torch.core.trace import TRACE_VM_VERSION
from repro_torch.dse.results import SweepRecord
from repro_torch.dse.space import (CacheOption, HostOption, SweepPoint,
                                   TpuOption)
from repro_torch.dse.store import NAMESPACE, workload_fingerprint

# Version stamp of the accelerator-mode analysis/selection/pricing
# semantics, mixed into every persisted TPU artifact key.  Bump it when the
# recorder, fusion_candidates/analyze_graph, the selection rule or the
# artifact schema changes: old TPU artifacts become unreachable while every
# other backend's stay warm.
TPU_ANALYSIS_VERSION = 2


class AnalysisBackend(abc.ABC):
    """One pipeline behind the engine: analyze → select → price.

    ==========  ==============================  ===========================
    phase       memoized by                     CiM / TPU incarnation
    ==========  ==============================  ===========================
    analyze     layer 1 (workload + geometry)   trace+IDG / ATen graph
    select      layer 2 (+ per-config knobs)    Algorithm 1 / fusion thr
    price       never (cheap, fanned out)       profile_system / roofline
    ==========  ==============================  ===========================

    Backends are small frozen dataclasses: picklable (they ride to
    ``executor="process"`` workers) and stateless — all memoization lives
    in the :class:`~repro_torch.dse.engine.AnalysisCache` they are handed,
    all persistence in the :class:`~repro_torch.dse.store.AnalysisStore`
    behind it.

    ``name`` namespaces persisted artifacts; ``version`` stamps them (a
    bump invalidates this backend's store entries and no one else's).
    """

    name: str = "abstract"

    @property
    def version(self) -> int:
        return 0

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

    def warm(self, cache, point: SweepPoint) -> None:
        """Build the layer-1 artifact ahead of the pricing fan-out (the
        engine warms each analysis key serially for deterministic build
        order and exactly one expensive pass per key)."""
        self.analyze(cache, point)

    def warm_many(self, cache, points: Sequence[SweepPoint]) -> None:
        """Warm one representative point per analysis key.  The engine
        hands over the whole key set at once so backends can batch across
        it; the default is the serial per-key warm."""
        for p in points:
            self.warm(cache, p)


def _refuse_tpu_point(point: SweepPoint) -> None:
    """A point of the ``tpus`` axis is never priced as CiM."""
    if point.tpu is not None:
        raise ValueError(f"{point.label} is an accelerator-mode point; "
                         f"price it with TpuBackend, not CimBackend")


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
    def version(self) -> int:
        return TRACE_VM_VERSION

    @property
    def variant(self) -> Optional[str]:
        """Memo-key discriminator for engines that share one cache across
        differently-configured backends: ``None`` for exact (the
        pre-sampling identity), else the sampling key."""
        return None if self.sampling.is_exact else self.sampling.key()

    def analyze(self, cache, point: SweepPoint):
        _refuse_tpu_point(point)
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
        for p in points:
            _refuse_tpu_point(p)
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
                        "version": self.version,
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


# ======================================================================
# TPU — ATen-graph fusion analysis, threshold selection, roofline pricing
# ======================================================================
@dataclasses.dataclass(frozen=True)
class TpuCandidate:
    """One VMEM-fusable chain, reduced to the numbers selection/pricing
    need (the graph itself is not persisted)."""
    n_ops: int
    input_bytes: int
    output_bytes: int
    saved_bytes: int

    @property
    def workset_bytes(self) -> int:
        """Resident footprint of the fused kernel: live inputs + outputs +
        the intermediates it keeps in VMEM (saved_bytes counts each
        intermediate's eliminated store+load, i.e. twice its size)."""
        return self.input_bytes + self.output_bytes + self.saved_bytes // 2


@dataclasses.dataclass(frozen=True)
class TpuWorkloadAnalysis:
    """Layer-1 TPU artifact: everything per-(workload, shape) and
    config-independent — picklable, so it persists like a CiM trace."""
    workload: str
    batch: int
    seq_len: int
    flops: float                   # matrix-product FLOPs of the graph
    total_bytes: int               # graph tensor traffic if nothing fuses
    collective_bytes: float        # per-device collective bytes (0 off-mesh)
    hlo_bytes: float               # non-view op footprint (reporting)
    n_eqns: int
    candidates: Tuple[TpuCandidate, ...]


@dataclasses.dataclass(frozen=True)
class TpuSelection:
    """Layer-2 TPU artifact: which candidates a TpuOption realizes."""
    n_accepted: int
    accepted_ops: int
    saved_bytes: int
    min_saved_bytes: int
    vmem_bytes: float


def record_train_step(cfg, batch: int, seq_len: int, device, seed: int = 0,
                      observe: Optional[Callable] = None):
    """Record ``make_train_step(cfg, TrainConfig())`` as an ATen graph
    (:class:`~repro_torch.core.hlo.Graph`), run eagerly on ``device`` with
    real tensors (``"cuda"`` raises without a card): parameters drawn from
    a generator seeded with ``seed``, zero moments and step, then a
    ``batch`` x ``seq_len`` batch from the same generator (token ids
    uniform over the vocabulary).  ``observe(new_state, metrics)``, if
    given, sees the step's outputs before they are freed; the state and
    the outputs are freed when this returns.  Span ``tpu.record``
    (``n_eqns``, ``fallback_eqns``: the recorder's eqns found by a pytree
    walk, ``tokens``)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.columnar import resolve_device
    from repro_torch.core.hlo import GraphRecorder
    from repro_torch.models import inputs as minputs
    from repro_torch.train import steps as steps_mod

    dev = resolve_device(device)
    with obs.span("tpu.record", cat="tpu", workload=cfg.arch_id,
                  tokens=batch * seq_len) as sp:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = steps_mod.init_train_state(gen, cfg, device=dev)
        data = minputs.make_train_batch(gen, cfg, batch=batch,
                                        seq_len=seq_len, device=dev)
        step = steps_mod.make_train_step(cfg, TrainConfig())
        rec = GraphRecorder()
        with rec:
            new_state, metrics = step(state, data)
        graph = rec.graph()
        sp.set(n_eqns=len(graph.eqns), fallback_eqns=rec.fallback_eqns)
        if observe is not None:
            observe(new_state, metrics)
    return graph


def analyze_train_step(cfg, batch: int, seq_len: int, device,
                       seed: int = 0, observe: Optional[Callable] = None
                       ) -> TpuWorkloadAnalysis:
    """Layer 1 of the accelerator-mode backend for one model config: the
    graph of :func:`record_train_step`, reduced to the numbers selection
    and pricing need.  Spans ``tpu.fusion`` (``n_candidates``) and
    ``tpu.cost``."""
    from repro_torch.core.hlo import fusion_candidates
    from repro_torch.core.hlo_cost import analyze_graph

    graph = record_train_step(cfg, batch, seq_len, device, seed, observe)
    with obs.span("tpu.fusion", cat="tpu") as sp:
        rep = fusion_candidates(graph)
        sp.set(n_candidates=len(rep.candidates))
    with obs.span("tpu.cost", cat="tpu"):
        cost = analyze_graph(graph)
    return TpuWorkloadAnalysis(
        workload=cfg.arch_id, batch=batch, seq_len=seq_len,
        flops=cost.flops, total_bytes=rep.total_bytes,
        collective_bytes=cost.collective_total, hlo_bytes=cost.bytes,
        n_eqns=len(graph.eqns),
        candidates=tuple(
            TpuCandidate(c.n_ops, c.input_bytes, c.output_bytes,
                         c.saved_bytes) for c in rep.candidates))


def model_config(workload: str, configs: Sequence = ()):
    """The configuration a TPU workload records: one of ``configs`` whose
    ``arch_id`` is ``workload``, else a ``registry.PUBLISHED``
    configuration, both as they are, else the arch id's reduced config."""
    from repro_torch.configs.registry import PUBLISHED, reduced_config
    for cfg in configs:
        if cfg.arch_id == workload:
            return cfg
    if workload in PUBLISHED:
        return PUBLISHED[workload]
    return reduced_config(workload)


@dataclasses.dataclass(frozen=True)
class TpuBackend(AnalysisBackend):
    """Accelerator-mode Eva-CiM: "does this model step benefit from
    VMEM-resident fusion, on which chip, at which aggressiveness".

    Workload names are arch ids from
    :data:`repro_torch.configs.registry.ARCHS`, whose *reduced* train step
    is recorded, or names of :data:`repro_torch.configs.registry.PUBLISHED`,
    recorded at their published widths (:func:`model_config`); ``analyze``
    records it once per (workload, batch, seq_len, seed) on the cache's
    device (:func:`analyze_train_step`), on weights drawn from ``seed``.
    ``configs`` adds configurations recorded as given, each under its
    ``arch_id``; ``observe`` (no part of the backend's identity) is handed
    to :func:`record_train_step`.  ``select`` realizes the candidates that
    clear the point's
    :class:`~repro_torch.dse.space.TpuOption` ``min_saved_bytes`` threshold
    *and* fit its (possibly scaled) VMEM.  ``price`` compares the unfused
    and fused steps under the option's chip: roofline bound time
    (:func:`~repro_torch.core.tpu_model.roofline_terms`) and step energy
    (:func:`~repro_torch.core.tpu_model.step_energy_pj`, with the
    eliminated HBM traffic re-priced as VMEM traffic rather than dropped).

    ``default_tpu`` prices points with no ``tpu`` axis value, mirroring
    the engine-default host of the CiM path.
    """

    batch: int = 2
    seq_len: int = 32
    default_tpu: TpuOption = TpuOption.of("v5e")
    seed: int = 0
    configs: Tuple = ()
    observe: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)

    name = "tpu"

    @property
    def version(self) -> int:
        return TPU_ANALYSIS_VERSION

    # ------------------------------------------------------------ layer 1
    def _layer1_spec(self, workload: str) -> Dict:
        return {"backend": f"{NAMESPACE}.{self.name}",
                "version": self.version, "workload": workload,
                "fingerprint": arch_fingerprint(workload, self.configs),
                "shape": [self.batch, self.seq_len], "seed": self.seed}

    def analyze(self, cache, point: SweepPoint) -> TpuWorkloadAnalysis:
        key = ("tpu", point.workload, self.batch, self.seq_len, self.seed)
        return cache.artifact(
            1, key, lambda: self._analyze(point.workload, cache.device),
            store_spec=self._layer1_spec(point.workload))

    def _analyze(self, workload: str, device) -> TpuWorkloadAnalysis:
        return analyze_train_step(model_config(workload, self.configs),
                                  self.batch, self.seq_len, device,
                                  self.seed, self.observe)

    # ------------------------------------------------------------ layer 2
    def _option(self, point: SweepPoint) -> TpuOption:
        return point.tpu if point.tpu is not None else self.default_tpu

    def select(self, cache, point: SweepPoint,
               analysis: TpuWorkloadAnalysis) -> TpuSelection:
        opt = self._option(point)
        vmem = opt.effective_chip().vmem_bytes
        key = ("tpu", analysis.workload, analysis.batch, analysis.seq_len,
               opt.min_saved_bytes, vmem)
        return cache.artifact(
            2, key, lambda: self._select(analysis, opt.min_saved_bytes, vmem))

    @staticmethod
    def _select(analysis: TpuWorkloadAnalysis, min_saved_bytes: int,
                vmem_bytes: float) -> TpuSelection:
        accepted = [c for c in analysis.candidates
                    if c.saved_bytes >= min_saved_bytes
                    and c.workset_bytes <= vmem_bytes]
        return TpuSelection(
            n_accepted=len(accepted),
            accepted_ops=sum(c.n_ops for c in accepted),
            saved_bytes=sum(c.saved_bytes for c in accepted),
            min_saved_bytes=min_saved_bytes, vmem_bytes=vmem_bytes)

    # ------------------------------------------------------------ pricing
    def price(self, point: SweepPoint, analysis: TpuWorkloadAnalysis,
              selection: TpuSelection, host: HostModel) -> SweepRecord:
        opt = self._option(point)
        chip = opt.effective_chip()
        base_bytes = float(analysis.total_bytes)
        fused_bytes = base_bytes - selection.saved_bytes
        coll = analysis.collective_bytes
        base = roofline_terms(analysis.flops, base_bytes, coll, 1, chip=chip)
        fused = roofline_terms(analysis.flops, fused_bytes, coll, 1,
                               chip=chip)
        base_e = step_energy_pj(analysis.flops, base_bytes, coll, 1,
                                chip=chip)
        fused_e = step_energy_pj(analysis.flops, fused_bytes, coll, 1,
                                 chip=chip)
        # eliminated HBM round-trips still move through VMEM — re-priced,
        # not free (the Eva-CiM analogue: CiM ops still cost array energy)
        fused_total = (fused_e["total_pj"]
                       + selection.saved_bytes * chip.pj_per_vmem_byte)
        macr = (selection.saved_bytes / base_bytes) if base_bytes else 0.0
        # "cycles" columns hold the roofline bound in ns (1 GHz convention),
        # so runtime_ms = cycles / 1e9 * 1e3 matches the CiM records' shape
        return SweepRecord(
            index=point.index, workload=point.workload,
            cache=opt.chip_label, cim_levels="VMEM", tech="tpu",
            cim_set=opt.threshold_label, host="-",
            energy_improvement=(base_e["total_pj"] / fused_total
                                if fused_total else 1.0),
            speedup=base.bound_s / fused.bound_s if fused.bound_s else 1.0,
            macr=macr, macr_l1=macr,
            base_energy_pj=base_e["total_pj"], cim_energy_pj=fused_total,
            base_cycles=base.bound_s * 1e9, cim_cycles=fused.bound_s * 1e9,
            base_runtime_ms=base.bound_s * 1e3,
            cim_runtime_ms=fused.bound_s * 1e3,
            processor_ratio=(base_e["compute_pj"] / base_e["total_pj"]
                             if base_e["total_pj"] else 0.0),
            cache_ratio=(base_e["hbm_pj"] / base_e["total_pj"]
                         if base_e["total_pj"] else 0.0),
            n_instructions=analysis.n_eqns,
            n_mem_accesses=int(analysis.total_bytes),
            n_candidates=len(analysis.candidates),
            n_cim_ops=selection.accepted_ops,
            backend=self.name)


_ARCH_FINGERPRINTS: Dict[str, str] = {}


def arch_fingerprint(workload: str, configs: Sequence = ()) -> str:
    """Content hash of a TPU workload: the arch id + the config it records
    (:func:`model_config`: every field that shapes the traced step).
    Editing a config — layer count, widths, MoE/SSM structure —
    invalidates the persisted analysis; unknown archs degrade to a
    name-only fingerprint."""
    given = [c for c in configs if c.arch_id == workload]
    cached = None if given else _ARCH_FINGERPRINTS.get(workload)
    if cached is not None:
        return cached
    spec = ""
    try:
        spec = repr(model_config(workload, given))
    except Exception:  # noqa: BLE001 — unknown arch / unimportable configs
        spec = ""
    digest = hashlib.sha256(f"{workload}\n{spec}".encode()).hexdigest()[:16]
    if not given:
        _ARCH_FINGERPRINTS[workload] = digest
    return digest
