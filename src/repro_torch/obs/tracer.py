"""Span tracer: nested wall-clock spans with cross-executor propagation.

Twin of ``repro/obs/tracer.py``: a copy, not an import, so the port never
loads the JAX package.

One process-global :class:`Tracer` (installed with :func:`enable`, removed
with :func:`disable`) collects finished spans as plain dicts.  Everything
is stdlib — ``contextvars`` carries the active span across call frames,
``threading`` guards the finished-span list, ``time`` supplies the clock.

Design rules, in order of importance:

* **Off is free.**  The module-global ``_tracer`` is the single switch:
  :func:`span` reads it once and hands back the shared :data:`NULL_SPAN`
  when tracing is off, so a hot loop pays one global read + one function
  call per would-be span and allocates nothing.  Call sites that sit on
  gated benchmark paths check ``obs.tracer() is None`` themselves and
  skip even the keyword-argument packing.
* **Propagation is explicit.**  ``contextvars`` does not follow
  ``ThreadPoolExecutor.submit``, so fan-out code captures
  :func:`current` (a :class:`TraceContext`) before submitting and wraps
  the worker body in :func:`attach`.  The same :class:`TraceContext` is
  a frozen two-string dataclass, so it pickles into
  ``executor="process"`` worker chunks unchanged; workers run their own
  :class:`Tracer`, :meth:`Tracer.drain` the finished spans, and ship
  them back for :func:`ingest` — span ids are prefixed with the owning
  pid, so worker spans parent into the coordinator's tree without
  collisions.
* **Clocks compose.**  Spans are timed with ``perf_counter_ns`` (never
  goes backwards) and exported on the unix epoch via a per-tracer
  offset captured at construction, so spans from different processes on
  one machine land on one consistent timeline.
* **Memory is bounded.**  ``max_spans`` caps the finished list; further
  spans are counted in ``dropped`` instead of growing the buffer (the
  DSE daemon additionally drains each request's spans into its own ring
  buffer the moment the request finishes).
"""
from __future__ import annotations

import contextvars
import dataclasses
import itertools
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

_current: contextvars.ContextVar[Optional["TraceContext"]] = \
    contextvars.ContextVar("eva_cim_trace_ctx", default=None)

_tracer: Optional["Tracer"] = None     # module-global on/off switch


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The propagation handle: which trace + which span is "current".

    Frozen, two strings — safe to capture before a thread-pool fan-out
    and to pickle into a spawned ``executor="process"`` worker."""
    trace_id: str
    span_id: str


class _NullSpan:
    """The shared do-nothing span handed out while tracing is off."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One in-flight span; finished spans live on as plain dicts.

    Use as a context manager — ``__enter__`` stamps the start time and
    makes this span the :func:`current` context, ``__exit__`` restores
    the parent and hands the finished record to the tracer.  ``set``
    attaches attributes at any point before exit (it only touches this
    span's own dict, so it is safe under any caller-held lock)."""

    __slots__ = ("_tracer", "name", "cat", "trace_id", "span_id",
                 "parent_id", "attrs", "_t0", "_token")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: str, span_id: str, parent_id: Optional[str],
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = 0
        self._token: Optional[contextvars.Token] = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._token = _current.set(TraceContext(self.trace_id, self.span_id))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._finish(self, dur_ns)
        return False


class Tracer:
    """Collector of finished spans + counter samples for one process."""

    def __init__(self, name: str = "eva-cim", max_spans: int = 200_000):
        self.name = name
        self.pid = os.getpid()
        self.max_spans = max_spans
        # maps perf_counter_ns() readings onto the unix epoch, so spans
        # from different processes share one timeline
        self._epoch_ns = time.time_ns() - time.perf_counter_ns()
        self._seq = itertools.count()         # next() is atomic in CPython
        self._lock = threading.Lock()
        self._spans: List[Dict] = []          # lint: guarded-by(_lock)
        self._samples: List[Dict] = []        # lint: guarded-by(_lock)
        self.dropped = 0                      # lint: guarded-by(_lock)

    # ------------------------------------------------------------- spans
    def _new_id(self) -> str:
        return f"{self.pid:x}.{next(self._seq):x}"

    def span(self, name: str, cat: str = "misc", **attrs) -> Span:
        """A new span under the current context (a fresh root trace when
        there is none)."""
        ctx = _current.get()
        if ctx is None:
            trace_id: str = uuid.uuid4().hex[:16]
            parent: Optional[str] = None
        else:
            trace_id, parent = ctx.trace_id, ctx.span_id
        return Span(self, name, cat, trace_id, self._new_id(), parent, attrs)

    def _finish(self, span: Span, dur_ns: int) -> None:
        thread = threading.current_thread()
        rec = {"name": span.name, "cat": span.cat,
               "trace_id": span.trace_id, "span_id": span.span_id,
               "parent_id": span.parent_id,
               "ts_ns": span._t0 + self._epoch_ns, "dur_ns": dur_ns,
               "pid": self.pid, "tid": thread.ident, "thread": thread.name,
               "attrs": dict(span.attrs)}
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
            else:
                self._spans.append(rec)

    # ----------------------------------------------------------- counters
    def counter(self, name: str, value: float) -> None:
        """Record one counter sample (a Chrome ``C`` event on export)."""
        sample = {"name": name, "value": float(value),
                  "ts_ns": time.perf_counter_ns() + self._epoch_ns,
                  "pid": self.pid}
        with self._lock:
            if len(self._samples) < self.max_spans:
                self._samples.append(sample)

    # ------------------------------------------------------------- access
    def spans(self) -> List[Dict]:
        with self._lock:
            return list(self._spans)

    def counters(self) -> List[Dict]:
        with self._lock:
            return list(self._samples)

    def ingest(self, spans: Iterable[Dict],
               samples: Iterable[Dict] = ()) -> None:
        """Adopt finished spans shipped from another tracer (typically a
        process-pool worker's :meth:`drain`) — already absolute-timed and
        pid-stamped, so they merge without translation."""
        spans, samples = list(spans), list(samples)
        with self._lock:
            self._spans.extend(spans)
            self._samples.extend(samples)

    def drain(self) -> Tuple[List[Dict], List[Dict]]:
        """Remove and return everything collected so far."""
        with self._lock:
            spans, samples = self._spans, self._samples
            self._spans = []
            self._samples = []
            return spans, samples

    def take(self, trace_id: str) -> List[Dict]:
        """Remove and return the finished spans of one trace (the DSE
        daemon calls this per request to keep the tracer's buffer from
        accumulating across its lifetime)."""
        with self._lock:
            taken = [s for s in self._spans if s["trace_id"] == trace_id]
            self._spans = [s for s in self._spans
                           if s["trace_id"] != trace_id]
        return taken

    # ------------------------------------------------------------ exports
    def export_chrome(self, path) -> int:
        """Write a Chrome trace-event JSON file (Perfetto-loadable);
        returns the number of span events written."""
        from repro_torch.obs import export
        return export.export_chrome(self.spans(), self.counters(), path)

    def export_ndjson(self, path) -> int:
        from repro_torch.obs import export
        return export.export_ndjson(self.spans(), path)

    def stage_attribution(self) -> Dict:
        from repro_torch.obs import export
        return export.stage_attribution(self.spans())


# ======================================================================
# Module-level switch + helpers (the API call sites actually use)
# ======================================================================
def tracer() -> Optional[Tracer]:
    """The installed tracer, or ``None`` when tracing is off — the one
    attribute read hot loops are allowed to pay."""
    return _tracer


def active() -> bool:
    return _tracer is not None


def enable(t: Optional[Tracer] = None) -> Tracer:
    """Install (or keep) the process-global tracer and return it."""
    global _tracer
    if t is not None:
        _tracer = t
    elif _tracer is None:
        _tracer = Tracer()
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def span(name: str, cat: str = "misc", **attrs):
    """A span under the current context — :data:`NULL_SPAN` when off."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, cat, **attrs)


def counter(name: str, value: float) -> None:
    t = _tracer
    if t is not None:
        t.counter(name, value)


def current() -> Optional[TraceContext]:
    """The pickle-able propagation handle for the active span (``None``
    when tracing is off or no span is open)."""
    if _tracer is None:
        return None
    return _current.get()


class _Attach:
    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> None:
        if self._ctx is not None:
            self._token = _current.set(self._ctx)

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        return False


def attach(ctx: Optional[TraceContext]) -> _Attach:
    """Re-establish a captured :class:`TraceContext` in another thread or
    process: spans opened inside parent under ``ctx``'s span.  ``None``
    (tracing was off at capture time) makes this a no-op."""
    return _Attach(ctx)


def ingest(spans: Sequence[Dict], samples: Sequence[Dict] = ()) -> None:
    """Adopt worker-shipped spans into the installed tracer, if any."""
    t = _tracer
    if t is not None and (spans or samples):
        t.ingest(spans, samples)
