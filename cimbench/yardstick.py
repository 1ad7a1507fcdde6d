"""The benchmark's fixed arithmetic: what it measures with, never what it
measures.  Copied, not imported, from the port, so that a change to the
program cannot move the yardstick:

* :func:`self_time_by_cat` is the self-time rule of the port's
  ``obs/export.py::stage_attribution`` (a span's duration less the
  durations of its children, clamped at zero; summed per category);
* :func:`k1_bytes` and :func:`bytes_bound_ms` are ``chip_smoke.py``'s
  byte count for the replay kernel (K1) and its bound over the card's
  memory rate;
* :func:`scale_host_clock` re-clocks a host preset as the port's
  ``A9-2GHz`` preset re-clocks ``A9-1GHz``;
* the peaks are NVIDIA's data sheet for the H100 SXM.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: H100 SXM data sheet: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
#: bytes one access costs K1 whatever the geometry count: an int64
#: address and a one-byte write flag, read once
K1_INPUT_BYTES = 8 + 1
#: bytes K1 writes per access and geometry: level (int8), hit (int8),
#: bank (int16), MSHR flag (bool)
K1_OUTPUT_BYTES = 1 + 1 + 2 + 1
#: the pricing constants a host re-clocked from its preset changes
_STALLS = ("l2_stall", "mem_stall")


def self_time_by_cat(spans: Sequence[Dict]) -> Dict[str, float]:
    """Seconds of self time per span category: each span's duration less
    the summed durations of its children that were recorded, clamped at
    zero.  Under a thread pool the children of one span overlap, so the
    figures are thread-seconds, not wall time."""
    by_id = {s["span_id"] for s in spans}
    children_ns: Dict[str, int] = {}
    for s in spans:
        parent = s.get("parent_id")
        if parent and parent in by_id:
            children_ns[parent] = children_ns.get(parent, 0) + s["dur_ns"]
    out: Dict[str, float] = {}
    for s in spans:
        self_ns = max(0, s["dur_ns"] - children_ns.get(s["span_id"], 0))
        cat = s["cat"] or "misc"
        out[cat] = out.get(cat, 0.0) + self_ns / 1e9
    return out


def span_total_s(spans: Iterable[Dict], name: str) -> float:
    """Summed duration, in seconds, of the spans called ``name``."""
    return sum(s["dur_ns"] for s in spans if s["name"] == name) / 1e9


def k1_bytes(n_accesses: int, n_geometries: int) -> int:
    """Bytes one K1 launch must move at least: each access's address and
    write flag read once, and its four response columns written once per
    geometry."""
    return n_accesses * (K1_INPUT_BYTES + K1_OUTPUT_BYTES * n_geometries)


def bytes_bound_ms(n_bytes: float) -> float:
    """Least time, in ms, to move ``n_bytes`` at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def rate(work: float, seconds: float) -> float:
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def p95(values: Sequence[float]) -> float:
    """95th percentile over every value (the inclusive method of
    ``statistics.quantiles``, which interpolates between order
    statistics)."""
    if len(values) < 2:
        raise ValueError("a percentile needs at least two values")
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def scale_host_clock(fields: Dict, ghz: float) -> Dict:
    """A host's pricing constants re-clocked to ``ghz``: the stalls, fixed
    in nanoseconds, grow with the clock in cycles, and the static energy,
    a fixed power, shrinks per cycle with its inverse."""
    ratio = ghz / fields["freq_ghz"]
    out = dict(fields)
    for k in _STALLS:
        out[k] = fields[k] * ratio
    out["static_pj_per_cycle"] = fields["static_pj_per_cycle"] / ratio
    out["freq_ghz"] = ghz
    out["name"] = f"{fields['name']}@{ghz:.6f}GHz"
    return out


def union_s(intervals: Iterable[Tuple[int, int]]) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    total = 0
    cur_s: Optional[int] = None
    cur_e = 0
    for s, e in sorted(intervals):
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        total += cur_e - cur_s
    return total / 1e9


def gaps(intervals: Iterable[Tuple[int, int]], start_ns: int, end_ns: int
         ) -> List[Tuple[int, int]]:
    """The idle stretches of ``[start_ns, end_ns]`` that no interval
    covers."""
    out = []
    cur = start_ns
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end_ns)))
        cur = max(cur, e)
        if cur >= end_ns:
            break
    if cur < end_ns:
        out.append((cur, end_ns))
    return [(s, e) for s, e in out if e > s]
