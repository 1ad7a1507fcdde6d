"""Span tracing for the port's pipeline (twin of ``repro.obs``).

The engine, the store, the backends and the adaptive loop open spans
through this package, as the reference's do.  Tracing is off by default
and free when off::

    from repro_torch import obs
    tracer = obs.enable()
    ...run a sweep...
    spans = tracer.spans()
    obs.disable()

The exporters (Perfetto JSON, NDJSON, stage attribution) wait for ROADMAP
Queue 1 item 7.
"""
from repro_torch.obs.tracer import (NULL_SPAN, Span, TraceContext, Tracer,
                                    active, attach, counter, current,
                                    disable, enable, ingest, span, tracer)

__all__ = [
    "NULL_SPAN", "Span", "TraceContext", "Tracer",
    "active", "attach", "counter", "current", "disable", "enable",
    "ingest", "span", "tracer",
]
