"""Span tracing for the port's pipeline (twin of ``repro.obs``).

The engine, the store, the backends, the adaptive loop and the DSE
service open spans through this package, as the reference's do, and the
finished spans export to Perfetto (Chrome trace-event JSON), NDJSON, or a
per-stage attribution table.  Tracing is off by default and free when
off::

    from repro_torch import obs
    tracer = obs.enable()
    ...run a sweep...
    tracer.export_chrome("trace.json")       # open in ui.perfetto.dev
    print(obs.attribution_markdown(obs.stage_attribution(tracer.spans())))
    obs.disable()
"""
from repro_torch.obs.tracer import (NULL_SPAN, Span, TraceContext, Tracer,
                                    active, attach, counter, current,
                                    disable, enable, ingest, span, tracer)
from repro_torch.obs.export import (attribution_markdown, build_tree,
                                    export_chrome, export_ndjson,
                                    stage_attribution)

__all__ = [
    "NULL_SPAN", "Span", "TraceContext", "Tracer",
    "active", "attach", "counter", "current", "disable", "enable",
    "ingest", "span", "tracer",
    "attribution_markdown", "build_tree", "export_chrome",
    "export_ndjson", "stage_attribution",
]
