"""Sweep executor: memoized trace analysis + fanned-out per-config pricing.

Twin of ``repro/dse/engine.py``, on an explicit device.  The pipeline
splits into phases with very different dependence on the swept axes:

  ========================  =====================  ========================
  phase                     depends on             where it runs
  ========================  =====================  ========================
  structural trace          workload only          trace VM on the host,
                                                   once per workload
  cache replay              + cache geometry       replay kernel (K1), one
                                                   launch per workload
  candidate selection       + cim_levels/cim_set   partition on the host,
                                                   placement kernel (K4)
  pricing (energy/cycles)   + tech, host           device bincounts + host
  ========================  =====================  ========================

:class:`AnalysisCache` memoizes the layers by their exact dependence keys
— including a per-workload structural-trace memo above layer 1, so a
Fig. 14 geometry sweep traces each program once and only replays its
access stream per geometry — so a Fig. 16 technology sweep re-runs nothing
but pricing, and a Fig. 15 level sweep re-runs placement only.  Backing
the cache with a persistent :class:`~repro_torch.dse.store.AnalysisStore`
extends both memo layers across processes.  The :class:`DSEEngine` walks
a :class:`~repro_torch.dse.space.SweepSpace` in deterministic order, warms
the cache once per analysis key, and fans the pricing phase out over a
worker pool ("thread", "process", or "serial") — records always come back
in SweepPoint order.

Both classes take ``device`` (default ``"cuda"``, which raises without a
card): every trace, flow table and selection they build or load lives
there, so on the card the replay and placement kernels run under the
engine, and on ``"cpu"`` their plain versions.  A workload's structural
trace comes from running its torch program
(:func:`repro_torch.workloads.build`) on the trace VM
(:func:`repro_torch.core.trace.trace_structural`), with its columns on the
engine's device.

The counters and their meaning are the reference's under
``EVA_CIM_ACCEL=jax``: ``replay_batches`` counts batched replays (one
kernel launch each), ``trace_builds`` every geometry replayed, and a
single-geometry replay (:meth:`AnalysisCache.trace`) is one launch that
``replay_batches`` does not count — :attr:`AnalysisCache.single_replays`
counts those, outside ``stats()``.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pathlib
import shutil
import tempfile
import threading
import time
import weakref
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from repro_torch import obs
from repro_torch.core import accel
from repro_torch.core.columnar import resolve_device
from repro_torch.core.host_model import DEFAULT_HOST, HostModel
from repro_torch.core.offload import (OffloadConfig, OffloadResult,
                                      TraceAnalysis, analyze_trace,
                                      rehydrate_analysis)
from repro_torch.core.reshape import ReshapedTrace, reshape
from repro_torch.core.trace import (StructuralTrace, TraceResult,
                                    attach_cache_results,
                                    attach_cache_results_batch,
                                    trace_structural)
from repro_torch.dse.backends import AnalysisBackend, CimBackend
from repro_torch.dse.results import SweepRecord, SweepResults
from repro_torch.dse.space import CacheOption, SweepPoint, SweepSpace
from repro_torch.dse.store import AnalysisStore

#: the kernels the engine launches: the replay (K1), placement (K4) and
#: pricing's counts (K9, one a point priced on the card)
ENGINE_KERNELS = ("replay", "place", "price_counts")


class AnalysisCache:
    """Layered memo of the config-independent sweep artifacts on ``device``.

    Layer 1 — ``(workload, cache)``  -> replayed trace + IDG/flow tables.
    Layer 2 — ``(layer-1 key, offload config)`` -> selected candidates +
    reshaped trace.  Hit/build counters are exposed for tests and reports.

    ``store`` (an :class:`~repro_torch.dse.store.AnalysisStore` or a
    directory path) layers an on-disk lookup between the in-memory memo and
    a fresh build: misses consult the store first, and every artifact built
    here is persisted, so a warm store means ``trace_builds == 0`` even in
    a new process.
    """

    def __init__(self, store: Optional[Union[AnalysisStore, str,
                                             pathlib.Path]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if store is not None and not isinstance(store, AnalysisStore):
            store = AnalysisStore(store)
        self.store = store
        self._lock = threading.RLock()
        self._structural: Dict[str, StructuralTrace] = {}  # lint: guarded-by(_lock)
        self._traces: Dict[Tuple, TraceResult] = {}        # lint: guarded-by(_lock)
        self._analyses: Dict[Tuple, TraceAnalysis] = {}    # lint: guarded-by(_lock)
        self._offloads: Dict[Tuple, Tuple[OffloadResult, ReshapedTrace]] = {}  # lint: guarded-by(_lock)
        self._blobs: Dict[Tuple, Any] = {}  # generic backend artifacts; lint: guarded-by(_lock)
        self._key_locks: Dict[Tuple, threading.Lock] = {}  # lint: guarded-by(_lock)
        self.trace_builds = 0    # lint: guarded-by(_lock)
        self.trace_hits = 0      # lint: guarded-by(_lock)
        self.offload_builds = 0  # lint: guarded-by(_lock)
        self.offload_hits = 0    # lint: guarded-by(_lock)
        self.replay_batches = 0  # lint: guarded-by(_lock)
        #: single-geometry replays (one K1 launch each on the card), which
        #: ``replay_batches`` does not count; not part of ``stats()``
        self.single_replays = 0  # lint: guarded-by(_lock)

    def _key_lock(self, key: Tuple) -> threading.Lock:
        """Per-key build lock: concurrent misses on one key build once."""
        with self._lock:
            lk = self._key_locks.get(key)
            if lk is None:
                lk = self._key_locks[key] = threading.Lock()
            return lk

    def _prune_lock(self, key: Tuple) -> None:
        """Release a build lock's table entry once its layer completed
        (threads already blocked on it hold a reference and find the memo
        populated)."""
        with self._lock:
            self._key_locks.pop(key, None)

    # ------------------------------------------------------------ layer 1
    def _structural_trace(self, workload: str) -> StructuralTrace:
        """The geometry-independent trace, interpreted once per workload —
        every cache geometry of a sweep replays its access stream instead
        of re-running the trace VM."""
        from repro_torch.workloads import build
        skey = ("structural", workload)
        with obs.span("cache.trace_vm", cat="trace", workload=workload) as sp:
            with self._key_lock(skey):
                try:
                    with self._lock:
                        st = self._structural.get(workload)
                    if st is None:
                        sp.set(source="build")
                        fn, args = build(workload)
                        st = trace_structural(fn, *args, device=self.device)
                        with self._lock:
                            self._structural[workload] = st
                    else:
                        sp.set(source="memo")
                    return st
                finally:
                    self._prune_lock(skey)

    def _adopt(self, workload: str, key: Tuple, loaded) -> TraceResult:
        """Memoize a layer-1 artifact loaded from the store."""
        tr, flow = loaded
        with self._lock:
            self._traces[key] = tr
            if tr.structural is not None and workload not in self._structural:
                self._structural[workload] = tr.structural
            if flow is not None and key not in self._analyses:
                self._analyses[key] = rehydrate_analysis(tr, flow)
        return tr

    def trace(self, workload: str, cache: CacheOption) -> TraceResult:
        key = (workload, cache.levels)             # full geometry, not name
        with obs.span("cache.trace", cat="replay", workload=workload,
                      cache=cache.name) as sp, self._key_lock(key):
            try:
                with self._lock:
                    hit = self._traces.get(key)
                    if hit is not None:
                        self.trace_hits += 1
                        sp.set(source="memo", layer=1)
                        return hit
                if self.store is not None:
                    loaded = self.store.load_layer1(workload, cache.levels,
                                                    self.device)
                    if loaded is not None:
                        sp.set(source="store", layer=1)
                        return self._adopt(workload, key, loaded)
                with self._lock:
                    self.trace_builds += 1
                    self.single_replays += 1
                sp.set(source="build", layer=1)
                tr = attach_cache_results(self._structural_trace(workload),
                                          cache.levels, device=self.device)
                with self._lock:
                    self._traces[key] = tr
                if self.store is not None:
                    self.store.save_layer1(workload, cache.levels, tr)
                return tr
            finally:
                self._prune_lock(key)

    def replay_group(self, workload: str,
                     caches: Sequence[CacheOption]) -> None:
        """Warm layer 1 for every geometry of one workload at once.

        A single-geometry group degrades to :meth:`trace`.  Otherwise all
        geometries still missing from memo *and* store replay in ONE
        :func:`~repro_torch.core.trace.attach_cache_results_batch` call —
        on the card one launch of the replay kernel — which
        ``replay_batches`` counts.  Counter semantics match :meth:`trace`:
        memo hits bump ``trace_hits``, store loads bump neither, and each
        geometry actually replayed bumps ``trace_builds``."""
        uniq: List[CacheOption] = []
        seen = set()
        for c in caches:
            if c.levels not in seen:
                seen.add(c.levels)
                uniq.append(c)
        if len(uniq) <= 1:
            for c in uniq:
                self.trace(workload, c)
            return
        gkey = ("replay_group", workload) + tuple(c.levels for c in uniq)
        with obs.span("cache.replay_batch", cat="replay", workload=workload,
                      n_geometries=len(uniq)) as gsp, self._key_lock(gkey):
            try:
                missing: List[CacheOption] = []
                for c in uniq:
                    key = (workload, c.levels)
                    with self._lock:
                        if key in self._traces:
                            self.trace_hits += 1
                            continue
                    if self.store is not None:
                        loaded = self.store.load_layer1(workload, c.levels,
                                                        self.device)
                        if loaded is not None:
                            self._adopt(workload, key, loaded)
                            continue
                    missing.append(c)
                gsp.set(n_replayed=len(missing),
                        source="build" if missing else "memo")
                if not missing:
                    return
                st = self._structural_trace(workload)
                trs = attach_cache_results_batch(
                    st, [c.levels for c in missing], device=self.device)
                with self._lock:
                    self.trace_builds += len(missing)
                    self.replay_batches += 1
                    for c, tr in zip(missing, trs):
                        self._traces[(workload, c.levels)] = tr
                if self.store is not None:
                    for c, tr in zip(missing, trs):
                        self.store.save_layer1(workload, c.levels, tr)
            finally:
                self._prune_lock(gkey)

    def trace_analysis(self, workload: str, cache: CacheOption
                       ) -> TraceAnalysis:
        """IDG/flow artifacts for a trace, built lazily on first use —
        callers that only need the raw trace never pay for the flow index."""
        key = (workload, cache.levels)
        with obs.span("cache.idg", cat="analysis", workload=workload,
                      cache=cache.name) as sp, \
                self._key_lock(("analysis",) + key):
            try:
                with self._lock:
                    hit = self._analyses.get(key)
                if hit is not None:
                    sp.set(source="memo")
                    return hit
                tr = self.trace(workload, cache)
                with self._lock:           # a store hit may have rehydrated it
                    hit = self._analyses.get(key)
                if hit is not None:
                    sp.set(source="store")
                    return hit
                sp.set(source="build")
                analysis = analyze_trace(tr)
                with self._lock:
                    self._analyses[key] = analysis
                if self.store is not None:
                    # upgrade the layer-1 artifact in place: trace + flow
                    self.store.save_layer1(workload, cache.levels, tr,
                                           flow=analysis.flow)
                return analysis
            finally:
                self._prune_lock(("analysis",) + key)

    # ------------------------------------------------------------ layer 2
    def offload(self, workload: str, cache: CacheOption,
                cfg: OffloadConfig) -> Tuple[OffloadResult, ReshapedTrace]:
        # the frozen OffloadConfig is hashable by value: using it directly
        # keeps the key complete if new knobs are ever added to it
        key = (workload, cache.levels, cfg)
        with obs.span("cache.select", cat="select", workload=workload,
                      cache=cache.name) as sp, self._key_lock(key):
            try:
                with self._lock:
                    hit = self._offloads.get(key)
                    if hit is not None:
                        self.offload_hits += 1
                        sp.set(source="memo", layer=2)
                        return hit
                if self.store is not None:
                    loaded = self.store.load_layer2(workload, cache.levels,
                                                    cfg, self.device)
                    if loaded is not None:
                        with self._lock:
                            self._offloads[key] = loaded
                        sp.set(source="store", layer=2)
                        return loaded
                with self._lock:
                    self.offload_builds += 1
                sp.set(source="build", layer=2)
                analysis = self.trace_analysis(workload, cache)
                # Algorithm 1: tree extraction, then placement
                with obs.span("select.candidates", cat="select") as cs:
                    result = analysis.select(cfg)
                    cs.set(n_candidates=len(result.candidates))
                reshaped = reshape(analysis.trace, result)
                with self._lock:
                    self._offloads[key] = (result, reshaped)
                if self.store is not None:
                    self.store.save_layer2(workload, cache.levels, cfg,
                                           result, reshaped)
                return result, reshaped
            finally:
                self._prune_lock(key)

    # ---------------------------------------------------- generic artifacts
    def artifact(self, layer: int, key: Tuple, build: Callable[[], Any],
                 store_spec: Optional[dict] = None) -> Any:
        """Backend-agnostic layered memo (the sampled pipeline's pieces).

        ``layer`` picks the counter pair the lookup accounts under — 1 for
        the expensive analysis phase (``trace_builds``/``trace_hits``), 2
        for selection (``offload_builds``/``offload_hits``).
        ``store_spec`` (a JSON-able key spec that must include the
        backend's name + version stamps) additionally persists the
        artifact through the :class:`~repro_torch.dse.store.AnalysisStore`:
        store loads count as neither build nor memo hit, mirroring the CiM
        layers, so ``trace_builds == 0`` still means "a warm run did no
        analysis work".  Per-key build locks: concurrent misses build
        once."""
        builds, hits = (("trace_builds", "trace_hits") if layer == 1
                        else ("offload_builds", "offload_hits"))
        full_key = (layer,) + key
        with obs.span(f"cache.artifact.l{layer}",
                      cat=("analysis" if layer == 1 else "select"),
                      layer=layer, key=str(key[:2])) as sp, \
                self._key_lock(("blob",) + full_key):
            try:
                with self._lock:
                    if full_key in self._blobs:
                        setattr(self, hits, getattr(self, hits) + 1)
                        sp.set(source="memo")
                        return self._blobs[full_key]
                if self.store is not None and store_spec is not None:
                    payload = self.store.load_blob(layer, store_spec)
                    if payload is not None:
                        value = payload["artifact"]
                        with self._lock:
                            self._blobs[full_key] = value
                        sp.set(source="store")
                        return value
                with self._lock:
                    setattr(self, builds, getattr(self, builds) + 1)
                sp.set(source="build")
                value = build()
                with self._lock:
                    self._blobs[full_key] = value
                if self.store is not None and store_spec is not None:
                    self.store.save_blob(layer, store_spec,
                                         {"artifact": value})
                return value
            finally:
                self._prune_lock(("blob",) + full_key)

    def stats(self) -> Dict[str, int]:
        out = {"trace_builds": self.trace_builds,
               "trace_hits": self.trace_hits,
               "offload_builds": self.offload_builds,
               "offload_hits": self.offload_hits,
               "replay_batches": self.replay_batches}
        if self.store is not None:
            out.update(self.store.stats())
        return out


# ======================================================================
# Engine
# ======================================================================
# Per-process worker caches for "process" mode, keyed by the store they
# route through and the device they build on (a process pool can outlive
# one engine/run).
_WORKER_CACHES: Dict[Tuple[Optional[str], Optional[int], str],
                     AnalysisCache] = {}


def _worker_chunk(points: Sequence[SweepPoint], host: HostModel,
                  backend: AnalysisBackend, device: str,
                  store_root: Optional[str] = None,
                  store_version: Optional[int] = None,
                  trace_ctx: Optional[obs.TraceContext] = None
                  ) -> Tuple[List[SweepRecord], Dict[str, int], List[Dict],
                             Dict[str, int]]:
    """Price a run of points inside one process-pool worker, on ``device``.

    Workers route every analysis miss through the shared on-disk
    :class:`~repro_torch.dse.store.AnalysisStore` at ``store_root``: the
    first worker to need a key builds it once and publishes the artifact,
    every other process (and every later run) loads it.  A worker whose
    ``device`` is unusable raises (:func:`resolve_device`); it never falls
    back to the CPU.  Returns the records, this chunk's delta of the
    cache+store counters, the finished span dicts collected under
    ``trace_ctx`` (empty when the parent was not tracing), and this
    chunk's delta of the replay and placement launch counts, so the parent
    can show that its workers launched the kernels."""
    cache_key = (store_root, store_version, device)
    cache = _WORKER_CACHES.get(cache_key)
    if cache is None:
        store = (AnalysisStore(store_root, version=store_version)
                 if store_root is not None else None)
        cache = _WORKER_CACHES[cache_key] = AnalysisCache(store=store,
                                                          device=device)
    before = cache.stats()
    launches_before = accel.launch_counts()
    spans: List[Dict] = []
    if trace_ctx is not None:
        # spans land in a worker-local tracer keyed to this pid; drain()
        # ships exactly this chunk's spans (workers run chunks serially)
        worker_tracer = obs.enable()
        with obs.attach(trace_ctx):
            with obs.span("worker.chunk", cat="engine",
                          workload=points[0].workload,
                          n_points=len(points), pid=os.getpid()):
                records = [backend.evaluate(cache, p, host) for p in points]
        spans, _ = worker_tracer.drain()
    else:
        records = [backend.evaluate(cache, p, host) for p in points]
    delta = {k: v - before.get(k, 0) for k, v in cache.stats().items()
             if not k.startswith("store_bytes")}   # gauges, not counters
    after = accel.launch_counts()
    launches = {k: after[k] - launches_before[k] for k in ENGINE_KERNELS}
    return records, delta, spans, launches


class DSEEngine:
    """Parallel design-space-exploration executor on ``device``.

    ``executor``:
      * ``"thread"`` (default) — one shared :class:`AnalysisCache`; the
        analysis keys are warmed serially (one batched replay per
        workload), then selection and pricing fan out over threads: on the
        card the placement launches come from the pool's threads.
      * ``"process"`` — points are chunked by analysis key and each chunk
        runs in a spawned worker process on the engine's device (each
        opens its own CUDA context on the card).  Workers share artifacts
        through an on-disk :class:`~repro_torch.dse.store.AnalysisStore` —
        the engine's ``store`` if it has one, else a per-engine scratch
        store — so every analysis key is built exactly once globally.
        Spawn semantics apply: call it from a real module (under ``if
        __name__ == "__main__":`` in scripts), not stdin.  The workers'
        replay, placement and count launches add up in
        :attr:`worker_launches`.
      * ``"serial"`` — no pool at all; useful for debugging and exact
        cost accounting.

    ``store`` — a persistent store (or a directory path) shared across
    processes and invocations; shorthand for
    ``cache=AnalysisCache(store=..., device=...)``.

    ``host`` — the default host model used to price points that do not
    carry their own (a ``SweepSpace(hosts=...)`` axis overrides it).

    ``backend`` — the :class:`~repro_torch.dse.backends.AnalysisBackend`
    behind this engine; defaults to the paper's CiM pipeline.

    ``device`` — where the cache builds (default ``"cuda"``; it raises
    without a card).  A ``cache`` passed in must live on the same device.
    """

    def __init__(self, cache: Optional[AnalysisCache] = None,
                 host: HostModel = DEFAULT_HOST,
                 executor: str = "thread",
                 max_workers: Optional[int] = None,
                 store: Optional[Union[AnalysisStore, str,
                                       pathlib.Path]] = None,
                 backend: Optional[AnalysisBackend] = None,
                 device="cuda"):
        if executor not in ("thread", "process", "serial"):
            raise ValueError(f"unknown executor {executor!r}")
        if cache is not None and store is not None:
            raise ValueError("pass either cache= or store= (to combine them, "
                             "build AnalysisCache(store=...) yourself)")
        dev = resolve_device(device)
        if cache is not None and cache.device != dev:
            raise ValueError(f"the cache lives on {cache.device}, the engine "
                             f"was asked for {dev}")
        self.analysis = cache or AnalysisCache(store=store, device=dev)
        self.device = dev
        self.host = host
        self.backend = backend or CimBackend()
        self.executor = executor
        self.max_workers = max_workers or min(8, os.cpu_count() or 1)
        #: replay, placement and count launches of this engine's process
        #: workers
        self.worker_launches: Dict[str, int] = dict.fromkeys(ENGINE_KERNELS,
                                                             0)
        self._scratch_store: Optional[AnalysisStore] = None

    def _worker_store(self) -> AnalysisStore:
        """Store handed to process workers: the engine's persistent one, or
        a lazily created per-engine scratch directory (cleaned up with the
        engine), so multi-process sweeps never rebuild an analysis key."""
        if self.analysis.store is not None:
            return self.analysis.store
        if self._scratch_store is None:
            tmp = tempfile.mkdtemp(prefix="evacim-torch-scratch-store-")
            self._scratch_store = AnalysisStore(tmp)
            weakref.finalize(self, shutil.rmtree, tmp, True)
        return self._scratch_store

    # ------------------------------------------------------------ pieces
    def evaluate(self, point: SweepPoint) -> SweepRecord:
        """Price one design point (memoized analysis)."""
        return self.backend.evaluate(self.analysis, point, self.host)

    @staticmethod
    def _chunks(points: Sequence[SweepPoint]) -> List[List[SweepPoint]]:
        """Contiguous runs sharing one analysis key (enumeration order is
        workload-major, so one pass suffices)."""
        chunks: List[List[SweepPoint]] = []
        for p in points:
            if chunks and chunks[-1][0].analysis_key == p.analysis_key:
                chunks[-1].append(p)
            else:
                chunks.append([p])
        return chunks

    # -------------------------------------------------------------- run
    def run(self, space: Union[SweepSpace, Sequence[SweepPoint]]
            ) -> SweepResults:
        """Price a full :class:`~repro_torch.dse.space.SweepSpace` — or any
        explicit subset of points.  A point sequence is re-indexed to its
        position in the sequence, so record order always matches input
        order; the returned ``stats`` are this call's counter deltas."""
        t0 = time.perf_counter()
        if isinstance(space, SweepSpace):
            points = space.points()
        else:
            points = [dataclasses.replace(p, index=i)
                      for i, p in enumerate(space)]
        records: List[Optional[SweepRecord]] = [None] * len(points)
        stats_before = self.analysis.stats()

        worker_stats: Optional[Dict[str, int]] = None
        with obs.span("dse.run", cat="engine", executor=self.executor,
                      backend=self.backend.name, n_points=len(points)):
            if self.executor == "serial":
                for p in points:
                    records[p.index] = self.evaluate(p)
            elif self.executor == "process":
                chunks = self._chunks(points)
                store = self._worker_store()
                trace_ctx = obs.current()    # pickled into every chunk
                # spawn, not fork: a forked child cannot use the parent's
                # CUDA context
                ctx = multiprocessing.get_context("spawn")
                with ProcessPoolExecutor(max_workers=self.max_workers,
                                         mp_context=ctx) as pool:
                    futs = [pool.submit(_worker_chunk, c, self.host,
                                        self.backend, str(self.device),
                                        str(store.root), store.version,
                                        trace_ctx)
                            for c in chunks]
                    worker_stats = {}
                    for fut in futs:
                        recs, delta, spans, launches = fut.result()
                        obs.ingest(spans)
                        for rec in recs:
                            records[rec.index] = rec
                        for k, v in delta.items():
                            worker_stats[k] = worker_stats.get(k, 0) + v
                        for k, v in launches.items():
                            self.worker_launches[k] += v
                # workers wrote behind this process's back: re-walk the store
                # so the byte gauges below reflect their artifacts
                if self.analysis.store is not None:
                    self.analysis.store.invalidate_usage_cache()
            else:
                # warm the analysis cache serially (deterministic build
                # order, one batched replay per workload), then fan out
                warm_keys = [c[0] for c in self._chunks(points)]
                with obs.span("engine.warm", cat="engine",
                              n_keys=len(warm_keys)):
                    self.backend.warm_many(self.analysis, warm_keys)
                trace_ctx = obs.current()
                if trace_ctx is None:
                    eval_fn = self.evaluate
                else:
                    # contextvars don't follow submit(): re-attach the run
                    # context in each pool thread so spans parent correctly
                    def eval_fn(point: SweepPoint) -> SweepRecord:
                        with obs.attach(trace_ctx):
                            return self.evaluate(point)
                with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                    for rec in pool.map(eval_fn, points):
                        records[rec.index] = rec

        # stats cover THIS run only, whatever the executor: thread/serial
        # report the shared-cache counter delta, process mode the summed
        # per-worker deltas (each chunk is one analysis key, so they agree)
        stats_after = self.analysis.stats()
        stats = worker_stats if worker_stats is not None else {
            k: v - stats_before.get(k, 0) for k, v in stats_after.items()}
        # store_bytes_* are gauges (current on-disk footprint), not
        # counters — report the absolute value, never a delta
        for k, v in stats_after.items():
            if k.startswith("store_bytes"):
                stats[k] = v
        return SweepResults(records=list(records), stats=stats,
                            elapsed_s=time.perf_counter() - t0)
