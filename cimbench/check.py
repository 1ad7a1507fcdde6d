"""What decides ``correct``: the program's outputs from the window against
the plain reference (:mod:`cimbench.ref`), worked out again from the
committed structural traces.

Every number compared is exact, so every limit is 0:

``replay_diff``
    (program, geometry) pairs of the sample whose per-access response
    columns (level, hit, bank, MSHR) or replay counters differ;
``select_diff``
    selections of the sample whose candidates (every field) or reshaped
    trace (surviving host instructions, CiM groups, moves, DRAM fills)
    differ;
``record_gap``
    over every field of every sampled record, the largest gap as a share
    of the reference's value (a differing name or count counts 1);
``missing``
    points of the window without their record, records labelled with
    another point, and sampled artifacts the program no longer held;

and in a sampled cell, per analysis checked:

``window_diff``
    windowed traces (marks, measured windows, every column's bytes) that
    differ from the original VM's for the spec's seed;
``plan_diff``
    plans whose picks differ from the reference's, and analyses whose
    skim counted other than the configuration's virtual instructions
    (every analysis of the window).

The replay, the selections and the record are then worked out by the
reference from the checked windowed columns: ``replay_diff`` counts the
measured windows whose response columns differ (and the hierarchy's
counters), ``select_diff`` the windows whose selections differ.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from cimbench.ref.offload import OffloadConfig
from cimbench.ref.pipeline import (CIM_SETS, LEVEL_PRESETS, Reference,
                                   cache_name, candidate_rows, host_label,
                                   host_model, reshaped_summary)

LIMITS = {"replay_diff": 0, "select_diff": 0, "record_gap": 0.0,
          "missing": 0, "window_diff": 0, "plan_diff": 0}
#: what the sample takes: (program, geometry) pairs of the passes (from
#: the two units whose engines the window kept), and requests or records
#: of the window
PAIRS = 6
RECORDS = 150


def field_gap(got, want) -> float:
    """0 for an equal field; for floats the gap as a share of the
    reference's value; 1 for anything else that differs."""
    if isinstance(want, float) and isinstance(got, (float, int)):
        if math.isnan(want) or math.isnan(got):
            return 0.0 if math.isnan(want) and math.isnan(got) else 1.0
        if got == want:
            return 0.0
        return abs(got - want) / max(abs(want), 1e-300)
    return 0.0 if got == want else 1.0


def record_gap(got: Optional[Dict], want: Dict) -> float:
    if got is None or set(got) != set(want):
        return 1.0
    return max(field_gap(got[k], want[k]) for k in want)


def identity(point: Dict, ref: Reference) -> tuple:
    """The labels a record of ``point`` must carry."""
    return (point["workload"], cache_name(ref.levels(point["geometry"])),
            "+".join(LEVEL_PRESETS[point["cim_levels"]]), point["tech"],
            point["cim_set"], host_label(host_model(point["host"])))


def labels(rec: Dict) -> tuple:
    return (rec["workload"], rec["cache"], rec["cim_levels"], rec["tech"],
            rec["cim_set"], rec["host"])


class Sample:
    """The program's outputs that the check reads, taken from the engines
    once the window has closed: records of the window, and for a sample
    of its (program, geometry) pairs the replay and the selections, or of
    its sampled analyses the plan, the windowed trace, the replay, the
    selections and the estimate."""

    def __init__(self):
        self.layer1: List[tuple] = []       # (workload, geometry, got)
        self.selections: List[tuple] = []   # (point, got)
        self.records: List[tuple] = []      # (point, index, got)
        self.analyses: List[Dict] = []      # sampled analyses
        self.skim_diff = 0
        self.missing = 0


def take_sample(port, units: Sequence[Dict], ref: Reference, seed: int,
                unit_kind: str) -> Sample:
    """Read, from the engines that ran ``units``, the outputs the check
    compares; the sample is drawn from ``seed``."""
    rng = random.Random(f"{seed}:check")
    s = Sample()
    for u in units:                        # every record's labels
        recs = u["out"]["records"]
        if len(recs) != len(u["points"]):
            s.missing += abs(len(u["points"]) - len(recs))
        for i, (p, r) in enumerate(zip(u["points"], recs)):
            if r is None or labels(r) != identity(p, ref) or (
                    unit_kind == "pass" and r["index"] != i):
                s.missing += 1
    if unit_kind == "request":
        chosen = rng.sample(range(len(units)), min(RECORDS, len(units)))
        slowest = max(range(len(units)), key=lambda i: units[i]["seconds"])
        for i in sorted(set(chosen) | {slowest}):
            u = units[i]
            p = u["points"][0]
            _read_pair(port, s, u["out"]["engines"][0], p["workload"],
                       p["geometry"], [p])
            s.records.append((p, 0, _record(u, 0)))
        return s
    pairs = sorted({(i, p["workload"], tuple(map(tuple, p["geometry"])))
                    for i, u in enumerate(units) for p in u["points"]
                    if u["out"]["engines"]})
    longest = [x for x in pairs if x[1] == "astar"]
    chosen = rng.sample(pairs, min(PAIRS, len(pairs)))
    if longest and not any(x[1] == "astar" for x in chosen):
        chosen[-1] = rng.choice(longest)
    for i, wl, geo in chosen:
        u = units[i]
        pts = [(j, p) for j, p in enumerate(u["points"])
               if p["workload"] == wl and tuple(map(tuple, p["geometry"]))
               == geo]
        _read_pair(port, s, u["out"]["engines"][0], wl, geo,
                   [p for _, p in pts])
        for j, p in pts[:RECORDS]:
            s.records.append((p, j, _record(u, j)))
    every = [(i, j) for i, u in enumerate(units)
             for j in range(len(u["points"]))]
    for i, j in rng.sample(every, min(RECORDS, len(every))):
        s.records.append((units[i]["points"][j], j, _record(units[i], j)))
    return s


def _record(unit: Dict, j: int) -> Optional[Dict]:
    recs = unit["out"]["records"]
    return recs[j] if j < len(recs) else None


def _read_pair(port, s: Sample, engine, workload: str, geometry,
               points: Sequence[Dict]) -> None:
    got = port.layer1(engine, workload, geometry)
    if got is None:
        s.missing += 1
    else:
        s.layer1.append((workload, geometry, got))
    seen = set()
    for p in points:
        key = (p["cim_levels"], p["cim_set"])
        if key in seen:
            continue
        seen.add(key)
        sel = port.selection(engine, p)
        if sel is None:
            s.missing += 1
        else:
            s.selections.append((p, sel))


def take_sampled(port, units: Sequence[Dict], seed: int,
                 virtual: int) -> Sample:
    """The sampled cells' counterpart of :func:`take_sample`: every
    analysis's skim count and record labels, and for two analyses drawn
    from ``seed`` everything the analysis memoized."""
    rng = random.Random(f"{seed}:check")
    s = Sample()
    ref = Reference(port.banks, port.mshrs)
    held = []
    for u in units:
        s.skim_diff += sum(v != virtual for v in u["out"]["virtual"])
        for j, p in enumerate(u["points"]):
            rec = _record(u, j)
            if rec is None or labels(rec) != identity(p, ref):
                s.missing += 1
            if u["out"]["engines"]:
                held.append((u, j))
    for u, j in rng.sample(held, min(2, len(held))):
        p = u["points"][j]
        got = port.sampled(u["out"]["engines"][j], p)
        if got is None:
            s.missing += 1
            continue
        sa, selections = got
        ss = sa.structural
        s.analyses.append({
            "point": p, "record": _record(u, j),
            "columns": ss.columns, "marks": [list(m) for m in ss.marks],
            "measured": list(ss.measured),
            "picks": [list(map(int, x)) for x in ss.plan.picks],
            "windows": [port.mem_columns(tr) for tr in sa.windows],
            "counters": dict(sa.cache.counters()),
            "selections": [port.selection_rows(r, sh)
                           for r, sh in selections]})
    return s


def compare_sampled(a: Dict, ref: Reference, float_type=float,
                    stand_in: bool = False) -> Dict[str, float]:
    """One sampled analysis against the reference: the windowed trace
    against the original VM's digests for the spec's seed, the plan, then
    the replay, selections and estimate worked out from those columns."""
    from cimbench.ref import sampling as rs
    p = a["point"]
    sp = p["sampling"]
    spec = rs.Spec(sp["mode"], sp["interval"], sp["budget"], sp["warmup"],
                   sp["seed"])
    want = rs.window_digests(p["workload"], spec.seed)
    window_diff = int(want is None or want["marks"] != a["marks"]
                      or want["measured"] != a["measured"]
                      or want["columns"] != rs.column_digests(a["columns"]))
    plan = rs.stratified_plan(want["total_virtual"], spec) if want else None
    plan_diff = int(plan is None
                    or [list(x) for x in plan.picks] != a["picks"])
    out = {"window_diff": window_diff, "plan_diff": plan_diff,
           "replay_diff": 0, "select_diff": 0, "record_gap": 1.0}
    if window_diff or plan_diff:
        return out
    full, hier = rs.replay(a["columns"], ref.levels(p["geometry"]))
    marks = a["marks"] if not a["measured"] else \
        [a["marks"][i] for i in a["measured"]]
    trs = rs.windows(full, hier, marks)
    out["replay_diff"] = int(hier.counters() != a["counters"]) + sum(
        not _same_columns(got, _mem_columns(tr))
        for got, tr in zip(a["windows"], trs))
    cfg = OffloadConfig(cim_set=CIM_SETS[p["cim_set"]],
                        cim_levels=LEVEL_PRESETS[p["cim_levels"]])
    sels = rs.select(trs, cfg)
    out["select_diff"] = sum(
        got != (candidate_rows(r), reshaped_summary(sh))
        for got, (r, sh) in zip(a["selections"], sels))
    host = host_model(p["host"])
    want_rec = sampled_record(p, rs.price(trs, sels, plan, spec, p["tech"],
                                          host), spec, host, ref)
    got_rec = a["record"]
    if stand_in:
        got_rec = sampled_record(p, rs.price(trs, sels, plan, spec,
                                             p["tech"], host, float_type),
                                 spec, host, ref)
    out["record_gap"] = record_gap(got_rec, want_rec)
    return out


def sampled_record(p: Dict, est: Dict, spec, host, ref: Reference) -> Dict:
    """Every field of a sampled record, from the estimate (the original
    package's ``CimBackend._record_from_estimate``)."""
    t, m, ci = est["totals"], est["metrics"], est["ci"]
    return {"index": 0, "workload": p["workload"],
            "cache": cache_name(ref.levels(p["geometry"])),
            "cim_levels": "+".join(LEVEL_PRESETS[p["cim_levels"]]),
            "tech": p["tech"], "cim_set": p["cim_set"],
            "host": host_label(host),
            "energy_improvement": float(m["energy_improvement"]),
            "speedup": float(m["speedup"]), "macr": float(m["macr"]),
            "macr_l1": float(m["macr_l1"]),
            "base_energy_pj": t["base_energy"],
            "cim_energy_pj": t["cim_energy"],
            "base_cycles": t["base_cycles"], "cim_cycles": t["cim_cycles"],
            "base_runtime_ms": host.runtime_ms(t["base_cycles"]),
            "cim_runtime_ms": host.runtime_ms(t["cim_cycles"]),
            "processor_ratio": float(m["processor_ratio"]),
            "cache_ratio": float(m["cache_ratio"]),
            "n_instructions": int(round(t["n_instructions"])),
            "n_mem_accesses": int(round(t["mem_accesses"])),
            "n_candidates": int(round(t["n_candidates"])),
            "n_cim_ops": int(round(t["n_cim_ops"])),
            "round": 0, "backend": "cim", "sampling": spec.key(),
            "energy_improvement_ci": ci["energy_improvement"],
            "speedup_ci": ci["speedup"], "macr_ci": ci["macr"]}


def _mem_columns(tr) -> Dict[str, np.ndarray]:
    mem = tr.trace.mem_mask
    return {k: getattr(tr.trace, k)[mem] for k in ("level", "hit", "bank",
                                                    "mshr")}


def _same_columns(got: Dict[str, np.ndarray],
                  want: Dict[str, np.ndarray]) -> bool:
    return all(got[k].dtype == want[k].dtype
               and np.array_equal(got[k], want[k]) for k in want)


def compare(sample: Sample, ref: Reference, float_type=float,
            stand_in: bool = False) -> Dict[str, float]:
    """The numbers compared.  ``stand_in`` puts the reference computed in
    ``float_type`` in the program's place for the records (the control):
    the program's own records are then not read."""
    replay_diff = 0
    for wl, geo, (cols, counters) in sample.layer1:
        want_cols, want_counters = ref.replay(wl, geo)
        if counters != want_counters or not _same_columns(cols, want_cols):
            replay_diff += 1
    select_diff = 0
    for p, (cands, summary) in sample.selections:
        result, shaped = ref.selection(p["workload"], p["geometry"],
                                       p["cim_levels"], p["cim_set"])
        if (cands, summary) != (candidate_rows(result),
                                reshaped_summary(shaped)):
            select_diff += 1
    gap = 0.0
    for p, index, got in sample.records:
        want = ref.record(p, index)
        if stand_in:
            got = ref.record(p, index, float_type=float_type)
        gap = max(gap, record_gap(got, want))
    out = {"replay_diff": replay_diff, "select_diff": select_diff,
           "record_gap": gap, "missing": sample.missing}
    if sample.analyses or sample.skim_diff:
        out.update(window_diff=0, plan_diff=sample.skim_diff)
        if not sample.analyses:
            out["missing"] += 1
    for a in sample.analyses:
        got = compare_sampled(a, ref, float_type, stand_in)
        for k, v in got.items():
            out[k] = max(out[k], v) if k == "record_gap" else out[k] + v
    return out


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in numbers)
