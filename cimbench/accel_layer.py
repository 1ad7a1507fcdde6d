"""Arithmetic of the accel kind's per-layer readers (``metrics/*.accel``):
span times per analysis, and the step's share of the card's peak.

A unit of the accel kind is one analysis, so "per analysis" is per unit
of the window.  A span's self time is its duration less that of its
child spans, clamped at zero (the rule of :mod:`cimbench.yardstick`).
"""
from __future__ import annotations

from typing import Optional

from cimbench.yardstick import span_total_s

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s
BF16_PEAK_FLOPS = 989e12


def _readable(run) -> bool:
    return bool(run.spans) and bool(run.units)


def span_ms_per_analysis(run, name: str) -> Optional[float]:
    """Summed duration of the spans called ``name``, in ms per analysis;
    ``None`` where the window holds no such span."""
    if not _readable(run) or not any(s["name"] == name for s in run.spans):
        return None
    return span_total_s(run.spans, name) * 1e3 / len(run.units)


def self_ms_per_analysis(run, name: str) -> Optional[float]:
    """Summed self time of the spans called ``name``, in ms per analysis;
    ``None`` where the window holds no such span."""
    if not _readable(run):
        return None
    ours = [s for s in run.spans if s["name"] == name]
    if not ours:
        return None
    ids = {s["span_id"] for s in ours}
    child_ns = {}
    for s in run.spans:
        if s.get("parent_id") in ids:
            child_ns[s["parent_id"]] = child_ns.get(s["parent_id"], 0) \
                + s["dur_ns"]
    ns = sum(max(0, s["dur_ns"] - child_ns.get(s["span_id"], 0))
             for s in ours)
    return ns / 1e6 / len(run.units)


def step_mfu(run) -> Optional[float]:
    """The window's steps' matrix-product FLOPs, as the benchmark counts
    them from the widths and the routing (``run.step_flops``), over the
    device's busy time and the card's bf16 peak, in %."""
    flops = getattr(run, "step_flops", None)
    if run.device is None or not flops or run.device.busy_s <= 0:
        return None
    return 100.0 * sum(flops) / run.device.busy_s / BF16_PEAK_FLOPS
