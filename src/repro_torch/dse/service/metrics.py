"""Observability plane of the DSE daemon — counters, gauges, histograms.

Twin of ``repro/dse/service/metrics.py``, a stdlib copy.

Everything the ``/metrics`` endpoint serves is a plain-JSON snapshot of
this registry plus the live cache/store counters the engine already
keeps.  The registry is deliberately tiny and stdlib-only:

* :class:`Counter` — monotonic (requests served, points coalesced),
* :class:`Gauge`   — instantaneous level (requests in flight),
* :class:`Histogram` — latency distribution: exact count/sum plus
  p50/p90/p99 estimated from a bounded reservoir of the most recent
  observations (a daemon cares about *recent* tail latency; an
  ever-growing exact quantile structure does not pay its way here).

All mutation goes through one registry lock — the hot path is a dict
lookup and a float add, contention is dwarfed by the work being
measured.  ``snapshot()`` returns plain ``dict``/``float`` values, so the
HTTP handler can ``json.dumps`` it directly.
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, List, Optional


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, by: int = 1) -> None:
        self.value += by


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, by: int = 1) -> None:
        self.value += by

    def dec(self, by: int = 1) -> None:
        self.value -= by

    def set(self, value: float) -> None:
        self.value = value


def _pick(ordered: List[float], q: float) -> Optional[float]:
    """Nearest-rank quantile over an ascending list (``None`` if empty).

    The single quantile implementation: :meth:`Histogram.quantile` and
    :meth:`Histogram.snapshot` both route through it, each sorting the
    reservoir exactly once."""
    if not ordered:
        return None
    return ordered[min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))]


class Histogram:
    """Latency summary: exact count/sum/max, reservoir quantiles."""

    __slots__ = ("count", "sum", "max", "_recent")

    def __init__(self, reservoir: int = 2048) -> None:
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._recent: Deque[float] = collections.deque(maxlen=reservoir)

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if value > self.max:
            self.max = value
        self._recent.append(value)

    def quantile(self, q: float) -> Optional[float]:
        return _pick(sorted(self._recent), q)

    def snapshot(self) -> Dict[str, Optional[float]]:
        ordered: List[float] = sorted(self._recent)
        return {"count": self.count, "sum": round(self.sum, 6),
                "mean": round(self.sum / self.count, 6) if self.count else None,
                "max": round(self.max, 6) if self.count else None,
                "p50": _pick(ordered, 0.50), "p90": _pick(ordered, 0.90),
                "p99": _pick(ordered, 0.99)}


class MetricsRegistry:
    """Named metric instruments, created on first use, one lock for all.

    Names are dotted paths (``"requests.sweep"``); ``snapshot()`` nests
    them back into a JSON-friendly tree, with histograms expanded to
    their summary dicts and quantiles rounded for readability.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}      # lint: guarded-by(_lock)
        self._gauges: Dict[str, Gauge] = {}          # lint: guarded-by(_lock)
        self._histograms: Dict[str, Histogram] = {}  # lint: guarded-by(_lock)

    # ------------------------------------------------------------ access
    def counter(self, name: str, by: int = 1) -> None:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            c.inc(by)

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def gauge_inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            g.inc(by)

    def gauge_dec(self, name: str, by: int = 1) -> None:
        self.gauge_inc(name, -by)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h.observe(value)

    def counter_value(self, name: str) -> int:
        with self._lock:
            c = self._counters.get(name)
            return c.value if c is not None else 0

    # ---------------------------------------------------------- snapshot
    @staticmethod
    def _nest(tree: Dict, name: str, value) -> None:
        """Nest one dotted metric name into the snapshot tree.

        Leaf/branch name clashes (a counter ``"a"`` next to a gauge
        ``"a.b"``, in either registration order) must not drop a metric:
        the clashing value is recorded at the top level under its
        *literal dotted name* instead of a nested path.  In the one case
        where even that key is taken — a dotless name whose slot already
        holds a branch — the literal key gets a ``"."`` suffix, so both
        the branch and the scalar survive the snapshot."""
        parts = name.split(".")
        node = tree
        clash = False
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):        # prefix is already a leaf
                clash = True
                break
            node = nxt
        if not clash and isinstance(node.get(parts[-1]), dict):
            clash = True                         # name is already a branch
        if clash:
            key = name if not isinstance(tree.get(name), dict) else name + "."
            tree[key] = value
            return
        node[parts[-1]] = value

    def snapshot(self) -> Dict:
        out: Dict = {}
        with self._lock:
            for name, c in sorted(self._counters.items()):
                self._nest(out, name, c.value)
            for name, g in sorted(self._gauges.items()):
                self._nest(out, name, g.value)
            for name, h in sorted(self._histograms.items()):
                self._nest(out, name, h.snapshot())
        return out
