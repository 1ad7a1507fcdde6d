"""Exporters + rollups over finished span dicts.

Twin of ``repro/obs/export.py``: a copy, so the port never loads the JAX
package.  Its documents equal the reference's for the same spans, apart
from ``otherData.producer``, which names this package.

Everything here is a pure function over the span/counter dicts a
:class:`repro_torch.obs.Tracer` collects (see ``tracer.py`` for the record
shape), so it works equally on a live tracer's buffer, a daemon ring
buffer entry, or spans re-read from an NDJSON log.

Three consumers, three formats:

* :func:`export_chrome` — Chrome trace-event JSON, the dialect
  Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` load:
  complete spans as ``ph:"X"`` events (``ts``/``dur`` in microseconds),
  counter samples as ``ph:"C"`` events, and ``ph:"M"`` metadata naming
  each pid/tid so the track labels read "eva-cim (pid 1234)" /
  "dse-worker-3" instead of bare numbers.
* :func:`export_ndjson` — one span dict per line, for grep/jq.
* :func:`stage_attribution` — the per-stage rollup behind
  ``examples/dse_cim.py --trace-report``: total and *self* time per
  category (self = duration minus children, clamped at zero — so with a
  serial executor the self times of a trace telescope back to its root
  span's duration), cache hit ratios from ``source=`` attributes, and a
  per-workload breakdown.  :func:`attribution_markdown` renders it.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

# span attrs tagging how a cache layer answered; memo/store count as
# hits (work reused), build as a miss, coalesced as a dedup'd wait
_HIT_SOURCES = ("memo", "store", "coalesced")
_MISS_SOURCES = ("build", "evaluated")


def _us(ns: int) -> float:
    return ns / 1000.0


def export_chrome(spans: Sequence[Dict], counters: Sequence[Dict] = (),
                  path: Any = None, name: str = "eva-cim") -> int:
    """Write Chrome trace-event JSON; returns the number of X events.

    ``path`` may be a filesystem path or an open text file.  Timestamps
    are rebased so the earliest event sits at ts=0 (Perfetto renders
    unix-epoch microseconds fine, but a zero origin keeps the numbers
    readable in the JSON itself)."""
    events: List[Dict] = []
    base_ns = min([s["ts_ns"] for s in spans]
                  + [c["ts_ns"] for c in counters]) if (spans or counters) \
        else 0
    seen_pids: Dict[int, None] = {}
    seen_tids: Dict[tuple, str] = {}
    for s in spans:
        pid, tid = s["pid"], s["tid"]
        seen_pids.setdefault(pid, None)
        seen_tids.setdefault((pid, tid), s.get("thread") or f"tid {tid}")
        args = dict(s["attrs"])
        args["trace_id"] = s["trace_id"]
        args["span_id"] = s["span_id"]
        if s["parent_id"]:
            args["parent_id"] = s["parent_id"]
        events.append({"name": s["name"], "cat": s["cat"] or "misc",
                       "ph": "X", "ts": _us(s["ts_ns"] - base_ns),
                       "dur": _us(s["dur_ns"]), "pid": pid, "tid": tid,
                       "args": args})
    n_span_events = len(events)
    for c in counters:
        pid = c["pid"]
        seen_pids.setdefault(pid, None)
        events.append({"name": c["name"], "cat": "counter", "ph": "C",
                       "ts": _us(c["ts_ns"] - base_ns), "pid": pid,
                       "tid": 0, "args": {"value": c["value"]}})
    meta: List[Dict] = []
    for pid in seen_pids:
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"{name} (pid {pid})"}})
    for (pid, tid), tname in seen_tids.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms",
           "otherData": {"producer": "repro_torch.obs",
                         "spans": n_span_events}}
    if hasattr(path, "write"):
        json.dump(doc, path)
    else:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return n_span_events


def export_ndjson(spans: Sequence[Dict], path: Any) -> int:
    """One finished-span dict per line; returns the line count."""
    if hasattr(path, "write"):
        for s in spans:
            path.write(json.dumps(s) + "\n")
        return len(spans)
    with open(path, "w") as fh:
        for s in spans:
            fh.write(json.dumps(s) + "\n")
    return len(spans)


def build_tree(spans: Sequence[Dict]) -> List[Dict]:
    """Nest spans into parent→children trees (roots returned, children
    under a ``"children"`` key, siblings in start-time order).  Spans
    whose parent is missing from the input are treated as roots."""
    by_id: Dict[str, Dict] = {}
    for s in spans:
        node = dict(s)
        node["children"] = []
        by_id[s["span_id"]] = node
    roots: List[Dict] = []
    for node in by_id.values():
        parent = node.get("parent_id")
        if parent and parent in by_id:
            by_id[parent]["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda n: n["ts_ns"])
    roots.sort(key=lambda n: n["ts_ns"])
    return roots


def stage_attribution(spans: Sequence[Dict]) -> Dict:
    """Per-stage (span category) rollup of where the time went.

    Returns::

        {"wall_s":        sum of root-span durations,
         "attributed_s":  sum of self times across all spans,
         "coverage":      attributed_s / wall_s   (≈1.0 for serial runs;
                          >1 signals overlapped/parallel children),
         "n_spans":       input size,
         "stages": {cat: {"count", "total_s", "self_s", "hits",
                          "misses", "hit_rate"}},
         "workloads": {workload: {cat: self_s}}}
    """
    by_id = {s["span_id"]: s for s in spans}
    children_ns: Dict[str, int] = {}
    for s in spans:
        parent = s.get("parent_id")
        if parent and parent in by_id:
            children_ns[parent] = children_ns.get(parent, 0) + s["dur_ns"]

    stages: Dict[str, Dict] = {}
    workloads: Dict[str, Dict[str, float]] = {}
    wall_ns = 0
    attributed_ns = 0
    for s in spans:
        if not (s.get("parent_id") and s["parent_id"] in by_id):
            wall_ns += s["dur_ns"]
        self_ns = max(0, s["dur_ns"] - children_ns.get(s["span_id"], 0))
        attributed_ns += self_ns
        cat = s["cat"] or "misc"
        st = stages.setdefault(cat, {"count": 0, "total_ns": 0,
                                     "self_ns": 0, "hits": 0, "misses": 0})
        st["count"] += 1
        st["total_ns"] += s["dur_ns"]
        st["self_ns"] += self_ns
        source = s["attrs"].get("source")
        if source in _HIT_SOURCES:
            st["hits"] += 1
        elif source in _MISS_SOURCES:
            st["misses"] += 1
        workload = s["attrs"].get("workload")
        if workload:
            per = workloads.setdefault(str(workload), {})
            per[cat] = per.get(cat, 0.0) + self_ns / 1e9

    out_stages: Dict[str, Dict] = {}
    for cat, st in sorted(stages.items(),
                          key=lambda kv: -kv[1]["self_ns"]):
        answered = st["hits"] + st["misses"]
        out_stages[cat] = {
            "count": st["count"],
            "total_s": st["total_ns"] / 1e9,
            "self_s": st["self_ns"] / 1e9,
            "hits": st["hits"],
            "misses": st["misses"],
            "hit_rate": (st["hits"] / answered) if answered else None,
        }
    wall_s = wall_ns / 1e9
    attributed_s = attributed_ns / 1e9
    return {"wall_s": wall_s, "attributed_s": attributed_s,
            "coverage": (attributed_s / wall_s) if wall_ns else 1.0,
            "n_spans": len(spans), "stages": out_stages,
            "workloads": {w: dict(sorted(per.items(),
                                         key=lambda kv: -kv[1]))
                          for w, per in sorted(workloads.items())}}


def attribution_markdown(att: Dict) -> str:
    """Render :func:`stage_attribution` output as markdown tables."""
    lines = ["| stage | spans | total s | self s | % wall | hit rate |",
             "|---|---:|---:|---:|---:|---:|"]
    wall_s = att["wall_s"] or 1e-12
    for cat, st in att["stages"].items():
        hit = f"{st['hit_rate']:.0%}" if st["hit_rate"] is not None else "-"
        lines.append(f"| {cat} | {st['count']} | {st['total_s']:.4f} "
                     f"| {st['self_s']:.4f} "
                     f"| {100.0 * st['self_s'] / wall_s:.1f}% | {hit} |")
    if att["workloads"]:
        lines.append("")
        lines.append("| workload | top stages (self s) |")
        lines.append("|---|---|")
        for workload, per in att["workloads"].items():
            top = ", ".join(f"{cat} {s:.4f}" for cat, s in
                            list(per.items())[:4])
            lines.append(f"| {workload} | {top} |")
    lines.append("")
    lines.append(f"spans {att['n_spans']} · wall {att['wall_s']:.4f}s · "
                 f"attributed {att['attributed_s']:.4f}s "
                 f"({att['coverage']:.1%})")
    return "\n".join(lines)
