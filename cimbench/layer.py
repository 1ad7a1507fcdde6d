"""Arithmetic shared by the per-layer metric readers (``metrics/``)."""
from __future__ import annotations

from typing import Optional

from cimbench.yardstick import bytes_bound_ms, k1_bytes, span_total_s


def self_ms_per_point(run, category: str) -> Optional[float]:
    """Self time of ``category``'s spans in ms per design point."""
    if not run.spans or not run.n_points:
        return None
    return run.self_s.get(category, 0.0) * 1e3 / run.n_points


def span_s_per_point(run, name: str) -> Optional[float]:
    """Summed seconds of the spans called ``name`` per design point (per
    analysis, in a sampled cell)."""
    if not run.spans or not run.n_points:
        return None
    return span_total_s(run.spans, name) / run.n_points


def k1_roofline(run) -> Optional[float]:
    """K1's bytes bound as a percentage of its device time; ``None``
    without a device trace or a launch, or when the trace and the spans
    disagree on the number of launches."""
    if run.device is None or not run.k1_launches:
        return None
    kernels = run.device.kernels("replay_kernel")
    if len(kernels) != len(run.k1_launches):
        return None
    device_ms = sum(e - s for _, s, e in kernels) / 1e6
    bound_ms = sum(bytes_bound_ms(k1_bytes(n, g))
                   for n, g in run.k1_launches)
    return 100.0 * bound_ms / device_ms


def device_idle(run) -> Optional[float]:
    """1 - busy / window over the traced window."""
    if run.device is None:
        return None
    return 1.0 - run.device.busy_s / run.device.window_s
