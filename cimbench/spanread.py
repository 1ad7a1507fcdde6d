"""Arithmetic shared by the per-layer readers of Algorithm 1's and
pricing's inner spans, of the time spans spend off the CPU, and of the
collector's pauses (``metrics/``).

They read what the program's tracer records beside a span's wall-clock
``dur_ns``: ``cpu_ns``, the thread's CPU time between the span's enter
and exit, and the attribute ``gc_ns``, the collector pauses charged to
the span while it was the innermost one open in its thread.  A window
whose spans carry no ``cpu_ns`` comes from a tracer that records
neither, and every reader returns ``None`` for it, never 0.
"""
from __future__ import annotations

from typing import Optional

from cimbench.yardstick import span_total_s


def _readable(run) -> bool:
    return bool(run.spans) and bool(run.n_points) and any(
        "cpu_ns" in s for s in run.spans)


def span_ms_per_point(run, name: str, less: Optional[str] = None
                      ) -> Optional[float]:
    """Summed wall-clock ms of the spans called ``name``, less that of
    the spans called ``less`` (its children), per design point."""
    if not _readable(run):
        return None
    s = span_total_s(run.spans, name)
    if less is not None:
        s -= span_total_s(run.spans, less)
    return s * 1e3 / run.n_points


def wait_ms_per_point(run, name: str) -> Optional[float]:
    """Summed ``dur_ns - cpu_ns`` of the spans called ``name``, in ms per
    design point: their time off the CPU."""
    if not _readable(run):
        return None
    ns = sum(s["dur_ns"] - s["cpu_ns"] for s in run.spans
             if s["name"] == name)
    return ns / 1e6 / run.n_points


def gc_ms_per_point(run) -> Optional[float]:
    """Collector pauses charged to the window's spans, in ms per design
    point (each pause is charged to one span, so each counts once)."""
    if not _readable(run):
        return None
    ns = sum(s["attrs"].get("gc_ns", 0) for s in run.spans)
    return ns / 1e6 / run.n_points
