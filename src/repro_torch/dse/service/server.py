"""The DSE daemon: one warm analysis substrate, many concurrent clients.

Twin of ``repro/dse/service/server.py``, on an explicit device.
:class:`DSEService` owns the modeling state a cold CLI pays for on every
invocation — one :class:`~repro_torch.dse.store.AnalysisStore` (optional,
via ``cache_dir``) under one in-memory
:class:`~repro_torch.dse.engine.AnalysisCache` *per backend*, on the
service's device — and serves sweep/adaptive queries over HTTP/JSON from a
stdlib :class:`~http.server.ThreadingHTTPServer`.  Three layers of
dedup/memoization stack up, coarsest first:

1. **Record memo** — a priced :class:`~repro_torch.dse.results.SweepRecord` per
   canonical ``(backend, SweepPoint.key)``: a repeated exhaustive sweep
   against a warm daemon re-prices *nothing* (bounded FIFO,
   ``memo_limit``).
2. **Single-flight** — concurrent requests whose point keys overlap share
   one in-flight evaluation per key (:mod:`.singleflight`): a key already
   running is never recomputed, the latecomer waits and receives the
   leader's record.
3. **Analysis cache/store** — the engine's layered memo (trace/IDG once
   per (workload, geometry), selection once per config) exactly as the
   CLI uses it, warm across every request the daemon ever serves.  On
   the card each request's warm pass launches the replay kernel (K1) from
   the request's handler thread, and each selection build launches the
   placement kernel (K4) from the request's pricing threads.

Responses are NDJSON streams (``application/x-ndjson``, chunked): every
response is a sequence of one-line JSON events ending with a ``result``
event, and adaptive requests additionally emit a ``round`` event the
moment each refinement round completes — a client steering exploration
sees the frontier move *while* later rounds are still pricing.

Endpoints:

  ``POST /v1/sweep``     exhaustive cross-product  → ``start``, ``result``
  ``POST /v1/adaptive``  frontier-driven refinement → ``start``,
  ``round``\\*, ``result``
  ``GET  /metrics``      observability snapshot (JSON); its ``accel``
  block holds the device and the kernels' launch counts
  ``GET  /healthz``      liveness + uptime
  ``GET  /v1/trace/<id>`` the span tree of a recent request

The backends are the reference's two: the CiM pipeline (``"cim"``) and
the accelerator-mode one (``"tpu"``, whose graph analyses also run on the
service's device).

Run it (``--device cuda`` is the default; it raises without a card)::

    PYTHONPATH=src python -m repro_torch.dse.service --port 8321 \\
        --cache-dir ~/.cache/eva-cim-torch
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core import accel
from repro_torch.core.columnar import resolve_device
from repro_torch.core.host_model import DEFAULT_HOST, HostModel
from repro_torch.dse.adaptive import AdaptiveDSE
from repro_torch.dse.backends import AnalysisBackend, CimBackend, TpuBackend
from repro_torch.dse.engine import AnalysisCache, DSEEngine
from repro_torch.dse.results import SweepRecord, SweepResults
from repro_torch.dse.service.codec import (RequestError, parse_request,
                                           records_json)
from repro_torch.dse.service.metrics import MetricsRegistry
from repro_torch.dse.service.singleflight import SingleFlight
from repro_torch.dse.space import SweepPoint
from repro_torch.dse.store import AnalysisStore


class _CoalescingEngine(DSEEngine):
    """A :class:`DSEEngine` whose per-point evaluation routes through the
    service's record memo + single-flight table.  Thread executor only:
    the daemon's worker threads are the fan-out, and process pools can't
    share an in-flight table.  The engine runs on the device of the
    shared cache it is handed."""

    def __init__(self, service: "DSEService", backend: AnalysisBackend,
                 cache: AnalysisCache, max_workers: int):
        super().__init__(cache=cache, executor="thread",
                         max_workers=max_workers, backend=backend,
                         device=cache.device)
        self._service = service

    def evaluate(self, point: SweepPoint) -> SweepRecord:
        return self._service.evaluate_point(self.backend, self.analysis,
                                            point, self.host)


class DSEService:
    """Warm modeling substrate + coalescing evaluator + metrics.

    ``cache_dir`` backs the backends' analysis caches with one shared
    persistent :class:`~repro_torch.dse.store.AnalysisStore` (artifacts
    are backend-namespaced and coexist); ``None`` keeps all state in
    memory for the daemon's lifetime.  ``device`` (default ``"cuda"``,
    which raises without a card; never a fallback to the CPU) is where
    every cache builds, so on the card the replay and placement kernels
    run under every request.  ``memo_limit`` bounds the
    priced-record memo (FIFO eviction).  Thread-safe throughout — the
    HTTP server hands every request its own thread.

    ``tracing`` (default on) installs the process-global
    :mod:`repro_torch.obs` tracer: every POST opens a root span whose
    ``trace_id`` is echoed in the NDJSON ``start`` event and the
    ``X-Trace-Id`` response header, and the finished span tree is served
    back by ``GET /v1/trace/<id>`` from a bounded ring of the last
    ``trace_buffer`` traces.
    """

    def __init__(self, cache_dir: Optional[str] = None,
                 max_workers: int = 4, memo_limit: int = 1 << 18,
                 host: HostModel = DEFAULT_HOST,
                 tracing: bool = True, trace_buffer: int = 64,
                 device="cuda"):
        self.device = resolve_device(device)
        self.started_at = time.time()
        self.metrics = MetricsRegistry()
        self.store: Optional[AnalysisStore] = (
            AnalysisStore(cache_dir) if cache_dir else None)
        self.host = host
        self.max_workers = max_workers
        self.memo_limit = memo_limit
        self._singleflight = SingleFlight()
        self._memo_lock = threading.Lock()
        self._memo: Dict[Tuple, SweepRecord] = {}  # lint: guarded-by(_memo_lock)
        self._backends: Dict[str, AnalysisBackend] = {"cim": CimBackend(),
                                                      "tpu": TpuBackend()}
        self._caches: Dict[str, AnalysisCache] = {
            name: AnalysisCache(store=self.store, device=self.device)
            for name in self._backends}
        self.trace_buffer = trace_buffer
        self._trace_lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, List[Dict]]" = \
            collections.OrderedDict()  # lint: guarded-by(_trace_lock)
        # remember whether tracing was ours to turn on, so close()
        # restores the caller's state instead of clobbering it
        self._owns_tracer = tracing and obs.tracer() is None
        if tracing:
            obs.enable()

    def close(self) -> None:
        """Release service-owned globals (the tracer, if this service
        installed it).  Idempotent; the HTTP layer keeps working, new
        requests just stop producing spans."""
        if self._owns_tracer:
            self._owns_tracer = False
            obs.disable()

    # ------------------------------------------------------------ engines
    def engine(self, backend_name: str,
               backend_obj: Optional[AnalysisBackend] = None) -> DSEEngine:
        """A fresh engine view over the shared per-backend cache — cheap,
        one per request, so concurrent runs never share executor state.
        ``backend_obj`` substitutes a per-request configuration of the
        named backend (e.g. a sampled :class:`CimBackend`) while keeping
        the shared cache — artifact keys carry the sampling identity, so
        variants coexist in one cache without collisions."""
        return _CoalescingEngine(self, backend_obj
                                 or self._backends[backend_name],
                                 self._caches[backend_name],
                                 self.max_workers)

    def analysis_cache(self, backend_name: str) -> AnalysisCache:
        """The shared analysis cache of one backend (its counters include
        ``single_replays``, which ``/metrics`` does not carry)."""
        return self._caches[backend_name]

    # ----------------------------------------------------- point evaluation
    def evaluate_point(self, backend: AnalysisBackend, cache: AnalysisCache,
                       point: SweepPoint, host: HostModel) -> SweepRecord:
        """Memo → single-flight → backend pipeline, in that order.

        The memo key is the point's canonical design identity plus the
        backend name and its variant (the sampling key for sampled CiM
        backends — a sampled estimate must never satisfy an exact query,
        or vice versa) — ``index`` and ``round`` are positional metadata,
        re-stamped per request, so one priced record serves every request
        that ever asks for that design.
        """
        variant = getattr(backend, "variant", None)
        key = (backend.name, variant, point.key)
        self.metrics.counter("points.requested")
        if variant is not None:
            self.metrics.counter("points.sampled")
        with obs.span("service.point", cat="engine", backend=backend.name,
                      workload=point.workload) as sp:
            with self._memo_lock:
                hit = self._memo.get(key)
            if hit is not None:
                self.metrics.counter("points.memo_hits")
                sp.set(source="memo")
                return dataclasses.replace(hit, index=point.index, round=0)

            source = "evaluated"

            def build() -> SweepRecord:
                # another flight for this key may have finished between the
                # memo check above and this flight's start: its record is
                # already in the memo, and evaluating again would count a
                # second evaluation of one key
                nonlocal source
                with self._memo_lock:
                    rec = self._memo.get(key)
                if rec is not None:
                    source = "memo"
                    return rec
                rec = backend.evaluate(cache, point, host)
                with self._memo_lock:
                    if len(self._memo) >= self.memo_limit:  # FIFO bound
                        self._memo.pop(next(iter(self._memo)))
                    self._memo[key] = rec
                self.metrics.counter("points.evaluated")
                return rec

            rec, coalesced = self._singleflight.do(key, build)
            if coalesced:
                self.metrics.counter("points.coalesced")
                source = "coalesced"
            elif source == "memo":
                self.metrics.counter("points.memo_hits")
            sp.set(source=source)
            return dataclasses.replace(rec, index=point.index, round=0)

    # ------------------------------------------------------------ queries
    def handle_query(self, doc: Dict,
                     trace_id: Optional[str] = None) -> Iterator[Dict]:
        """Parse + run one request, yielding NDJSON event dicts.

        ``start`` → (``round`` per adaptive refinement round) → ``result``.
        Raises :class:`~repro_torch.dse.service.codec.RequestError` before
        the first yield for malformed requests (the HTTP layer maps it to a
        400 **before** committing to a streamed 200).  ``trace_id`` (the
        HTTP layer's root span, when tracing) is echoed in the ``start``
        event so streaming clients can fetch ``/v1/trace/<id>`` later.
        """
        req = parse_request(doc)
        yield from self.run_request(req, trace_id)

    def run_request(self, req: Dict,
                    trace_id: Optional[str] = None) -> Iterator[Dict]:
        """The events of one parsed request (:func:`parse_request`'s
        dict).  An in-process caller may hand a ``space`` the wire
        vocabulary cannot name, such as a cache geometry that is no
        preset."""
        space, backend = req["space"], req["backend"]
        sampling = req["sampling"]
        backend_obj = None
        if backend == "cim" and not sampling.is_exact:
            backend_obj = dataclasses.replace(self._backends["cim"],
                                              sampling=sampling)
        engine = self.engine(backend, backend_obj)
        start = {"event": "start", "backend": backend, "mode": req["mode"],
                 "n_points": len(space), "n_analyses": space.n_analyses()}
        if not sampling.is_exact:
            start["sampling"] = sampling.key()
        if trace_id is not None:
            start["trace_id"] = trace_id
        yield start
        if req["mode"] == "adaptive":
            adaptive = AdaptiveDSE(space, engine=engine,
                                   objectives=req["objectives"],
                                   max_rounds=req["max_rounds"])
            last = None
            for event in adaptive.run_iter():
                info = event.info
                yield {"event": "round", "round": info.round,
                       "n_candidates": info.n_candidates,
                       "n_priced": info.n_priced,
                       "frontier_size": info.frontier_size,
                       "stable": info.stable,
                       "elapsed_s": round(info.elapsed_s, 4),
                       "stats": info.stats,
                       "frontier": records_json(event.frontier)}
                last = event
            results = (last.results if last is not None
                       else SweepResults(records=[]))
            frontier = last.frontier if last is not None else []
            yield self._result_event(results, frontier,
                                     n_rounds=(last.info.round + 1
                                               if last else 0))
        else:
            results = engine.run(space)
            frontier = results.pareto(req["objectives"])
            yield self._result_event(results, frontier)

    @staticmethod
    def _result_event(results: SweepResults, frontier: List[SweepRecord],
                      **extra) -> Dict:
        return {"event": "result", "n_records": len(results),
                "elapsed_s": round(results.elapsed_s, 4),
                "stats": results.stats,
                "records": records_json(results.records),
                "frontier": records_json(frontier), **extra}

    # ------------------------------------------------------------- traces
    def finish_trace(self, trace_id: Optional[str]) -> None:
        """Drain a finished request's spans out of the tracer into the
        bounded ring buffer and roll their self-times into the metrics
        (``obs.spans`` counter + per-stage ``obs.stage_self_s`` gauges)."""
        t = obs.tracer()
        if t is None or trace_id is None:
            return
        spans = t.take(trace_id)
        if not spans:
            return
        with self._trace_lock:
            self._traces[trace_id] = spans
            while len(self._traces) > self.trace_buffer:
                self._traces.popitem(last=False)
        self.metrics.counter("obs.spans", len(spans))
        att = obs.stage_attribution(spans)
        for cat, st in att["stages"].items():
            self.metrics.gauge_inc(f"obs.stage_self_s.{cat}",
                                   round(st["self_s"], 6))

    def trace_tree(self, trace_id: str) -> Optional[Dict]:
        """The finished span tree of a recent request (or ``None``)."""
        with self._trace_lock:
            spans = self._traces.get(trace_id)
        if spans is None:
            return None
        return {"trace_id": trace_id, "n_spans": len(spans),
                "spans": obs.build_tree(spans)}

    def buffered_spans(self) -> List[Dict]:
        """Every span of the traces in the ring, oldest trace first (the
        input of :func:`repro_torch.obs.stage_attribution` over recent
        requests)."""
        with self._trace_lock:
            return [s for spans in self._traces.values() for s in spans]

    # ------------------------------------------------------------ metrics
    def metrics_snapshot(self) -> Dict:
        doc = {
            "uptime_s": round(time.time() - self.started_at, 3),
            "service": self.metrics.snapshot(),
            "inflight_keys": self._singleflight.inflight(),
            "memo_records": len(self._memo),
            "cache": {},
        }
        svc = doc["service"].setdefault("points", {})
        requested = svc.get("requested", 0)
        evaluated = svc.get("evaluated", 0)
        svc.setdefault("coalesced", 0)
        svc.setdefault("memo_hits", 0)
        svc.setdefault("sampled", 0)
        # the headline number: how many point-prices one evaluation served
        doc["dedup_ratio"] = (round(requested / evaluated, 3)
                              if evaluated else None)
        for name, cache in self._caches.items():
            stats = cache.stats()
            layers = {}
            for layer, (b, h) in (("layer1", ("trace_builds", "trace_hits")),
                                  ("layer2", ("offload_builds",
                                              "offload_hits"))):
                builds, hits = stats.get(b, 0), stats.get(h, 0)
                layers[layer] = {
                    "builds": builds, "hits": hits,
                    "hit_rate": (round(hits / (hits + builds), 3)
                                 if hits + builds else None)}
            layers["replay_batches"] = stats.get("replay_batches", 0)
            doc["cache"][name] = layers
        # the port's counterpart of the reference's accel backend and jit
        # compiles: the device, and each kernel's launches in this process
        doc["accel"] = {"device": str(self.device),
                        "launches": accel.launch_counts()}
        t = obs.tracer()
        with self._trace_lock:
            buffered = len(self._traces)
        doc["obs"] = {"tracing": t is not None,
                      "buffered_traces": buffered,
                      "dropped_spans": t.dropped if t is not None else 0}
        if self.store is not None:
            doc["store"] = self.store.stats()
            doc["store"]["corrupt_drops"] = self.store.corrupt_drops
        return doc


# ======================================================================
# HTTP layer
# ======================================================================
class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    service: DSEService                     # set by make_server()
    quiet: bool = True

    # --------------------------------------------------------- plumbing
    def log_message(self, fmt: str, *args) -> None:     # noqa: N802
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send_json(self, code: int, doc: Dict) -> None:
        body = json.dumps(doc).encode() + b"\n"
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _stream_ndjson(self, events: Iterator[Dict],
                       headers: Optional[Dict[str, str]] = None,
                       on_complete: Optional[Callable[[], None]] = None
                       ) -> None:
        """Chunked NDJSON: one event per line, flushed as produced, so a
        client sees each ``round`` while later rounds are still running.

        ``on_complete`` runs after the last event but *before* the
        terminal chunk — a client that saw the stream end is guaranteed
        its side effects (trace buffering) already happened."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()

        def chunk(data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data + b"\r\n")
            self.wfile.flush()

        try:
            for event in events:
                chunk(json.dumps(event).encode() + b"\n")
        except Exception as exc:  # noqa: BLE001 — stream must terminate
            # mid-stream failure: the status line is long gone, so the
            # error travels in-band as a terminal event line
            chunk(json.dumps({"event": "error",
                              "error": str(exc)}).encode() + b"\n")
        if on_complete is not None:
            on_complete()
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    # --------------------------------------------------------- endpoints
    def do_GET(self) -> None:               # noqa: N802
        t0 = time.perf_counter()
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            svc = self.service
            self._send_json(200, {
                "status": "ok",
                "uptime_s": round(time.time() - svc.started_at, 3),
                "backends": sorted(svc._backends)})
        elif path == "/metrics":
            self._send_json(200, self.service.metrics_snapshot())
        elif path.startswith("/v1/trace/"):
            trace_id = path.rsplit("/", 1)[1]
            tree = self.service.trace_tree(trace_id)
            if tree is None:
                self._send_json(404, {"error": f"no buffered trace "
                                               f"{trace_id!r} (finished "
                                               f"traces are kept in a "
                                               f"bounded ring)"})
                return
            self._send_json(200, tree)
            path = "/trace"                  # one metric series, not per-id
        else:
            self._send_json(404, {"error": f"unknown path {path!r}"})
            return
        self.service.metrics.counter(f"requests.{path.strip('/')}")
        self.service.metrics.observe(f"latency_s.{path.strip('/')}",
                                     time.perf_counter() - t0)

    def do_POST(self) -> None:              # noqa: N802
        path = self.path.split("?", 1)[0]
        endpoint = {"/v1/sweep": "sweep", "/v1/adaptive": "adaptive"}.get(path)
        if endpoint is None:
            self._send_json(404, {"error": f"unknown path {path!r}"})
            return
        svc = self.service
        t0 = time.perf_counter()
        svc.metrics.counter(f"requests.{endpoint}")
        svc.metrics.gauge_inc("inflight_requests")
        # the request's root span: everything the handler thread (and the
        # engine threads/processes it fans out to) does nests under it;
        # trace_id is None when tracing is off (NULL_SPAN)
        root = obs.span(f"http.{endpoint}", cat="service", endpoint=endpoint)
        trace_id = root.trace_id
        root.__enter__()
        finished = False

        def finish_request() -> None:
            # close the root span + buffer the trace exactly once, before
            # the client sees the stream terminate (so /v1/trace/<id>
            # resolves the moment a reply is fully read)
            nonlocal finished
            if not finished:
                finished = True
                root.__exit__(None, None, None)
                svc.finish_trace(trace_id)

        try:
            try:
                length = int(self.headers.get("Content-Length", "0"))
                doc = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                svc.metrics.counter("requests.bad")
                self._send_json(400, {"error": "body must be valid JSON"})
                return
            doc["mode"] = endpoint           # the path, not the body, decides
            try:
                events = svc.handle_query(doc, trace_id=trace_id)
                first = next(events)         # parse errors surface here,
            except RequestError as exc:      # before the 200 is committed
                svc.metrics.counter("requests.bad")
                self._send_json(400, {"error": str(exc)})
                return
            self._stream_ndjson(
                _chain_first(first, events),
                headers=({"X-Trace-Id": trace_id} if trace_id else None),
                on_complete=finish_request)
        finally:
            finish_request()
            svc.metrics.gauge_dec("inflight_requests")
            svc.metrics.observe(f"latency_s.{endpoint}",
                                time.perf_counter() - t0)


def _chain_first(first: Dict, rest: Iterator[Dict]) -> Iterator[Dict]:
    yield first
    yield from rest


def make_server(service: DSEService, host: str = "127.0.0.1",
                port: int = 0, quiet: bool = True) -> ThreadingHTTPServer:
    """Bind a ready-to-run server (``port=0`` → ephemeral; read
    ``server.server_address``).  Call ``serve_forever()`` on it — in a
    thread for tests/benchmarks, directly for the daemon."""
    handler = type("BoundHandler", (_Handler,),
                   {"service": service, "quiet": quiet})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


@contextlib.contextmanager
def running_server(service: Optional[DSEService] = None,
                   host: str = "127.0.0.1", port: int = 0,
                   **service_kwargs):
    """In-process daemon for tests/benchmarks/examples::

        with running_server(cache_dir=tmp) as (url, service):
            ServiceClient(url).sweep(...)
    """
    service = service or DSEService(**service_kwargs)
    server = make_server(service, host=host, port=port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bound_host, bound_port = server.server_address[:2]
        yield f"http://{bound_host}:{bound_port}", service
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        service.close()      # restore the caller's tracing state


# ======================================================================
# Daemon entry point
# ======================================================================
def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.service",
        description="Eva-CiM DSE daemon: sweep/adaptive queries over "
                    "HTTP/JSON with one warm analysis cache")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321,
                    help="0 picks an ephemeral port (printed on startup)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent AnalysisStore directory shared with "
                         "the CLI tools")
    ap.add_argument("--device", default="cuda",
                    help="where the analysis runs: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--max-workers", type=int, default=4,
                    help="pricing fan-out threads per request")
    ap.add_argument("--verbose", action="store_true",
                    help="log every request to stderr")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable per-request span tracing "
                         "(X-Trace-Id / GET /v1/trace/<id>)")
    args = ap.parse_args(argv)

    service = DSEService(cache_dir=args.cache_dir,
                         max_workers=args.max_workers,
                         tracing=not args.no_trace, device=args.device)
    server = make_server(service, host=args.host, port=args.port,
                         quiet=not args.verbose)
    bound_host, bound_port = server.server_address[:2]
    print(f"[dse.service] serving on http://{bound_host}:{bound_port} "
          f"(cache_dir={args.cache_dir or 'in-memory'}, "
          f"device={service.device})", flush=True)

    def _shutdown(signum, frame):
        print(f"[dse.service] signal {signum}: shutting down", flush=True)
        # shutdown() must come from another thread than serve_forever()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    print("[dse.service] clean shutdown", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
