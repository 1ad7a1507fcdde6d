"""Single-flight execution table — in-flight work shared across callers.

Twin of ``repro/dse/service/singleflight.py``, a stdlib copy.

The daemon's coalescing guarantee ("never recompute a key already
running") is exactly Go's ``singleflight`` primitive: the first caller of
a key runs the build, every concurrent caller of the same key *waits on
the first caller's flight* instead of starting its own, and all of them
receive the one result.  The :class:`~repro_torch.dse.engine.AnalysisCache`
already serializes the expensive layer-1/2 *analysis* builds per key;
this table extends the guarantee to whole point evaluations across
concurrent HTTP requests, and reports how much work it saved
(``coalesced`` — flights joined rather than started).

Failure semantics: an exception raised by the build propagates to the
leader *and* to every waiter of that flight (they were promised that
flight's result), but is never cached — the next caller after the flight
completes starts a fresh one, so a transient failure doesn't poison the
key forever.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Hashable, Tuple


class _Flight:
    __slots__ = ("event", "value", "error", "waiters")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value: Any = None
        self.error: BaseException | None = None
        self.waiters = 0


class SingleFlight:
    """``do(key, fn)`` — run ``fn`` once per key among concurrent callers.

    Returns ``(value, coalesced)``: ``coalesced`` is True when this call
    joined another caller's in-flight build instead of running its own.
    Counters (monotonic, read without locking for metrics snapshots):

    * ``started``   — flights this table actually executed,
    * ``coalesced`` — calls served by waiting on someone else's flight.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flights: Dict[Hashable, _Flight] = {}  # lint: guarded-by(_lock)
        self.started = 0     # lint: guarded-by(_lock)
        self.coalesced = 0   # lint: guarded-by(_lock)

    def do(self, key: Hashable,
           fn: Callable[[], Any]) -> Tuple[Any, bool]:
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                flight.waiters += 1
                self.coalesced += 1
                leader = False
            else:
                flight = self._flights[key] = _Flight()
                self.started += 1
                leader = True
        if not leader:
            flight.event.wait()
            if flight.error is not None:
                raise flight.error
            return flight.value, True
        try:
            flight.value = fn()
        except BaseException as exc:       # propagate to leader + waiters
            flight.error = exc
            raise
        finally:
            with self._lock:
                self._flights.pop(key, None)
            flight.event.set()
        return flight.value, False

    def inflight(self) -> int:
        """Number of keys currently being built (metrics gauge)."""
        with self._lock:
            return len(self._flights)
