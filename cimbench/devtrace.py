"""The device's side of a traced window, from ``torch.profiler`` (CUDA
activity only: the host's spans come from the program's tracer).

A marker kernel (``torch.cuda._sleep``) launched right after the trace
starts ties the profiler's clock to the host's ``perf_counter_ns``, so
each idle stretch of the device can be named by what the host was doing
then.
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cimbench.yardstick import gaps, union_s

Event = Tuple[str, int, int]          # (name, start ns, end ns), host clock


class DeviceTrace:
    """Context manager around a window on ``device``; on a CPU device it
    records nothing and :attr:`events` stays ``None``."""

    MARKER = "spin"

    def __init__(self, device: str):
        self.device = device
        self.events: Optional[List[Event]] = None
        self.start_ns = self.end_ns = 0
        self._prof = None
        self._marker_host_ns = 0

    def __enter__(self) -> "DeviceTrace":
        if self.device.startswith("cuda"):
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda.synchronize()
            self._marker_host_ns = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._prof is not None:
            torch.cuda.synchronize()
        self.end_ns = time.perf_counter_ns()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.events = self._read()
        return False

    def _raw(self) -> List[Tuple[str, int, int]]:
        """(name, start, end) of every device event, in the profiler's
        clock (ns)."""
        from torch.autograd import DeviceType
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out

    def _read(self) -> List[Event]:
        raw = self._raw()
        marker = min((s for n, s, _ in raw if self.MARKER in n),
                     default=None)
        if marker is None:
            raise RuntimeError("the device trace holds no marker kernel")
        shift = self._marker_host_ns - marker
        return sorted((n, s + shift, e + shift) for n, s, e in raw
                      if not (self.MARKER in n and s == marker))

    # ------------------------------------------------------------ views
    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def intervals(self) -> List[Tuple[int, int]]:
        return [(max(s, self.start_ns), min(e, self.end_ns))
                for _, s, e in self.events or ()
                if e > self.start_ns and s < self.end_ns]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return union_s(self.intervals())

    def kernels(self, name_part: str) -> List[Event]:
        return [ev for ev in self.events or () if name_part in ev[0]]

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.events or ():
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, spans: Sequence[Dict], epoch_ns: int,
                     n: int = 10) -> List[List]:
        """Idle seconds of the device summed by the innermost host span
        (the latest started of those open) at each idle stretch's
        midpoint, "(no span)" where none is open.  ``epoch_ns`` maps the
        spans' ``ts_ns`` back onto ``perf_counter_ns``."""
        opened = sorted((s["ts_ns"] - epoch_ns,
                         s["ts_ns"] - epoch_ns + s["dur_ns"], s["name"])
                        for s in spans)
        by: Dict[str, float] = {}
        heap: List[Tuple[int, int, str]] = []
        i = 0
        for a, b in gaps(self.intervals(), self.start_ns, self.end_ns):
            mid = (a + b) // 2
            while i < len(opened) and opened[i][0] <= mid:
                s0, s1, name = opened[i]
                heapq.heappush(heap, (-s0, s1, name))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            inner = heap[0][2] if heap else "(no span)"
            by[inner] = by.get(inner, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]
