"""repro_torch.dse.service — the port's DSE engine as a long-running daemon.

Twin of ``repro.dse.service``: one resident :class:`DSEService` owns a
warm :class:`~repro_torch.dse.engine.AnalysisCache` on its device
(optionally over a persistent :class:`~repro_torch.dse.store.AnalysisStore`)
and serves sweep, adaptive and sampled queries from many concurrent
clients over HTTP/JSON, with the reference's request vocabulary, records,
counters and event streams:

  * :mod:`.server`       — :class:`DSEService` + stdlib
    ``ThreadingHTTPServer`` front end; NDJSON-streamed responses
    (adaptive rounds land line-by-line as they complete); the
    ``python -m repro_torch.dse.service`` daemon entry point,
  * :mod:`.singleflight` — the coalescing primitive: concurrent requests
    whose canonical point keys overlap share one in-flight evaluation,
  * :mod:`.metrics`      — counters/gauges/latency histograms behind
    ``GET /metrics`` (cache + store hit rates and kernel launches ride
    along),
  * :mod:`.codec`        — JSON request validation ⇄ typed ``SweepSpace``,
  * :mod:`.client`       — stdlib-only client library
    (:class:`ServiceClient`), used by ``python -m repro_torch.bench
    service``.

Quickstart (``--device cuda`` is the default and raises without a card)::

    PYTHONPATH=src python -m repro_torch.dse.service --port 8321

    from repro_torch.dse.service import ServiceClient
    client = ServiceClient("http://127.0.0.1:8321")
    reply = client.sweep(["KM"], techs=["sram", "fefet"])
    for event in client.adaptive_events(["KM"], caches=["32K+256K",
                                                        "64K+2M"]):
        print(event["event"])      # start, round..., result
"""
from repro_torch.dse.service.client import (ServiceClient, ServiceError,
                                            SweepReply)
from repro_torch.dse.service.codec import RequestError, parse_request
from repro_torch.dse.service.metrics import MetricsRegistry
from repro_torch.dse.service.server import (DSEService, make_server, main,
                                            running_server)
from repro_torch.dse.service.singleflight import SingleFlight

__all__ = [
    "DSEService", "MetricsRegistry", "RequestError", "ServiceClient",
    "ServiceError", "SingleFlight", "SweepReply", "make_server", "main",
    "parse_request", "running_server",
]
