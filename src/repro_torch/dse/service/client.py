"""Client library for the DSE daemon — stdlib HTTP, streaming-aware.

Twin of ``repro/dse/service/client.py``, a stdlib copy.
:class:`ServiceClient` is the programmatic face of
``python -m repro_torch.dse.service``: build a request dict (or let the helper
methods build it), POST it, and either collect the final result
(:meth:`sweep`) or iterate NDJSON events as the daemon emits them
(:meth:`stream` / :meth:`adaptive_events`) — an adaptive client sees
every ``round`` event, frontier included, while later rounds are still
pricing on the server.

Built on :mod:`http.client` so the daemon's consumers need nothing the
standard library doesn't ship; chunked transfer decoding and
line-buffered reads come for free from :class:`http.client.HTTPResponse`.
"""
from __future__ import annotations

import http.client
import json
import socket
import time
import urllib.parse
from typing import Dict, Iterator, List, Optional, Sequence, Union


class ServiceError(RuntimeError):
    """Non-2xx response, or an in-band ``error`` event from a stream."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class SweepReply:
    """The terminal ``result`` event, plus any ``round`` events that
    preceded it — one object whether the query was exhaustive or
    adaptive."""

    def __init__(self, events: List[Dict]):
        self.events = events
        self.rounds = [e for e in events if e.get("event") == "round"]
        finals = [e for e in events if e.get("event") == "result"]
        if not finals:
            raise ServiceError("stream ended without a result event")
        self.result = finals[-1]

    @property
    def records(self) -> List[Dict]:
        return self.result["records"]

    @property
    def frontier(self) -> List[Dict]:
        return self.result["frontier"]

    @property
    def stats(self) -> Dict:
        return self.result.get("stats", {})

    @property
    def trace_id(self) -> Optional[str]:
        """The server-side trace id from the ``start`` event (``None``
        when the daemon runs with tracing disabled); feed it to
        :meth:`ServiceClient.trace` for the request's span tree."""
        for e in self.events:
            if e.get("event") == "start":
                return e.get("trace_id")
        return None


class ServiceClient:
    """One daemon endpoint (``http://host:port``), any number of calls.

    A connection per call: the daemon is thread-per-request and the
    dominant cost is the sweep itself, so connection reuse buys nothing
    and per-call connections keep the client trivially thread-safe.
    """

    def __init__(self, base_url: str, timeout: float = 600.0):
        parsed = urllib.parse.urlsplit(base_url)
        if parsed.scheme != "http" or parsed.hostname is None:
            raise ValueError(f"expected an http://host:port URL, "
                             f"got {base_url!r}")
        self.host = parsed.hostname
        self.port = parsed.port or 80
        self.timeout = timeout

    # ------------------------------------------------------------ plumbing
    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _get_json(self, path: str) -> Dict:
        conn = self._connect()
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise ServiceError(body.decode(errors="replace"),
                                   status=resp.status)
            return json.loads(body)
        finally:
            conn.close()

    def stream(self, request: Dict,
               endpoint: Optional[str] = None) -> Iterator[Dict]:
        """POST a request document, yield each NDJSON event as it arrives.

        ``endpoint`` defaults to the request's ``mode`` (``sweep`` /
        ``adaptive``).  An in-band ``error`` event raises
        :class:`ServiceError` after any earlier events were yielded.
        """
        endpoint = endpoint or request.get("mode", "sweep")
        conn = self._connect()
        try:
            body = json.dumps(request).encode()
            conn.request("POST", f"/v1/{endpoint}", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                payload = resp.read().decode(errors="replace")
                try:
                    payload = json.loads(payload).get("error", payload)
                except (json.JSONDecodeError, AttributeError):
                    pass
                raise ServiceError(payload, status=resp.status)
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                if event.get("event") == "error":
                    raise ServiceError(event.get("error", "server error"))
                yield event
        finally:
            conn.close()

    # ------------------------------------------------------------- queries
    def sweep(self, workloads: Sequence[str], *, backend: str = "cim",
              adaptive: bool = False, **axes) -> SweepReply:
        """Run a query and collect the full reply.

        ``axes`` pass through to the request document: ``caches``,
        ``cim_levels``, ``techs``, ``cim_sets``, ``hosts`` (CiM),
        ``tpus`` (TPU), ``objectives``/``max_rounds`` (adaptive).
        """
        request = {"workloads": list(workloads), "backend": backend,
                   "mode": "adaptive" if adaptive else "sweep"}
        request.update({k: v for k, v in axes.items() if v is not None})
        return SweepReply(list(self.stream(request)))

    def adaptive_events(self, workloads: Sequence[str], *,
                        backend: str = "cim", **axes) -> Iterator[Dict]:
        """Streaming adaptive query: yields ``start``, each ``round`` as
        its pricing completes, then the terminal ``result``."""
        request = {"workloads": list(workloads), "backend": backend,
                   "mode": "adaptive"}
        request.update({k: v for k, v in axes.items() if v is not None})
        return self.stream(request)

    # ------------------------------------------------------ observability
    def healthz(self) -> Dict:
        return self._get_json("/healthz")

    def metrics(self) -> Dict:
        return self._get_json("/metrics")

    def trace(self, trace_id: str) -> Dict:
        """The finished span tree of a recent request (404 →
        :class:`ServiceError`: the id fell out of the daemon's ring)."""
        return self._get_json(f"/v1/trace/{urllib.parse.quote(trace_id)}")

    def wait_ready(self, deadline_s: float = 15.0) -> Dict:
        """Block until the daemon answers ``/healthz`` (startup races in
        benchmarks/CI), raising :class:`ServiceError` on timeout."""
        deadline = time.monotonic() + deadline_s
        last: Union[Exception, None] = None
        while time.monotonic() < deadline:
            try:
                return self.healthz()
            except (ConnectionError, socket.timeout, OSError,
                    ServiceError) as exc:
                last = exc
                time.sleep(0.05)
        raise ServiceError(f"daemon at {self.host}:{self.port} not ready "
                           f"after {deadline_s}s: {last}")
