"""Committed reference traces of the 17 Table-IV workloads: the oracle.

The port traces its own programs (:mod:`repro_torch.workloads`, the trace
VM of :mod:`repro_torch.core.trace`); the engine never reads these files.
They hold what the reference's VM commits, so the tests and
``chip_smoke.py`` can compare the port's VM with it where jax is absent
(the card's machine may have none).  ``fixtures/<NAME>.npz`` holds, for
each workload, the reference trace's layer-1 columns
(``ColumnarTrace.to_arrays()``), the program outputs (``out_<i>``) and
``meta_*`` entries: the trace-VM and
analysis versions, the jax version that traced it and the instruction
count.  ``fixtures/reference_reports.json`` holds the reference's priced
reports for every design point of :data:`CACHES` x :data:`LEVEL_SETS` x
:data:`TECHS`, plus each geometry's replay counters.

Both are written by ``python tests/test_torch_fixtures.py --regenerate``.

``fixtures/reference_artifacts/`` holds the reference's paper artifacts
(each of ``repro_torch.bench.run.ALL`` as a ``.csv`` and a ``.json``, as
``python -m benchmarks.run`` writes them) and ``records.json``: the full
``SweepRecord.to_dict()`` records of the fig14–17 and fig_adaptive spaces,
and the adaptive run's records, frontier and rounds on fig_adaptive's
space.  ``python tests/test_torch_bench.py --regenerate`` writes them.

``fixtures/reference_single_pass.json`` holds the reference's
single-pass Algorithm 1 (the placement-dependent branch) on the 17
workloads under :data:`SINGLE_PASS_CACHE`, for each of
:data:`SINGLE_PASS_CONFIGS` and each technology: the candidates' digest
(:func:`candidate_digest`), the claimed count and the
:data:`RECORD_FIELDS` (:func:`single_pass_records`); and the lines that
``examples/quickstart.py`` and ``examples/evaluate_workloads.py`` (SRAM
and FeFET) print, less their timings (:func:`example_lines`).
``python tests/test_torch_fixtures.py --regenerate`` writes it.

``fixtures/reference_sampled.json`` holds the reference's sampled
pipeline (``repro.core.sampling``): for ``KM@256`` under the sampling
benchmark's ``SYNTH_SPEC`` (:mod:`repro_torch.bench.sampling`) in both
modes, the plan, the marks, the row count, one
sha256 per windowed column and the estimate (:func:`sampled_summary`);
and the 17 workloads' sampled sweep records under the default spec, both
modes.  ``python tests/test_torch_sampling.py --regenerate`` writes it.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cache import L1_32K, L1_64K, L2_256K, L2_2M
from repro_torch.core.columnar import ColumnarTrace, resolve_device
from repro_torch.core.offload import OffloadConfig
from repro_torch.core.profiler import SystemReport
from repro_torch.core.trace import StructuralTrace
from repro_torch.dse import CacheOption, SweepSpace

FIXTURE_DIR = pathlib.Path(__file__).resolve().parent / "fixtures"
REPORTS_PATH = FIXTURE_DIR / "reference_reports.json"
ARTIFACTS_DIR = FIXTURE_DIR / "reference_artifacts"
RECORDS_PATH = ARTIFACTS_DIR / "records.json"
SAMPLED_PATH = FIXTURE_DIR / "reference_sampled.json"
SINGLE_PASS_PATH = FIXTURE_DIR / "reference_single_pass.json"


WORKLOADS = ("NB", "DT", "SVM", "LiR", "KM", "LCS", "M2D", "BFS", "DFS",
             "BC", "SSSP", "CCOMP", "PRANK", "astar", "h264ref", "hmmer",
             "mcf")
CATEGORY = {
    "NB": "ml", "DT": "ml", "SVM": "ml", "LiR": "ml", "KM": "ml",
    "LCS": "string", "M2D": "media",
    "BFS": "graph", "DFS": "graph", "BC": "graph", "SSSP": "graph",
    "CCOMP": "graph", "PRANK": "graph",
    "astar": "spec", "h264ref": "spec", "hmmer": "spec", "mcf": "spec",
}

# the design points of the reference's figures
CACHES = {"32K+256K": (L1_32K, L2_256K),      # Fig. 14 geometries
          "64K+256K": (L1_64K, L2_256K),
          "64K+2M": (L1_64K, L2_2M)}
LEVEL_SETS = {"L1_only": ("L1",),             # Fig. 15 CiM level sets
              "L2_only": ("L2",),
              "both": ("L1", "L2")}
TECHS = ("sram", "fefet")                     # Fig. 16 technologies

#: the per-point fields the golden reports hold, all compared with ==
RECORD_FIELDS = ("energy_improvement", "speedup", "macr", "macr_l1",
                 "n_candidates", "n_offloaded")

# the single-pass (placement-dependent) Algorithm 1 configurations, as
# OffloadConfig keyword arguments of either package, and their geometry
SINGLE_PASS_CACHE = "32K+256K"
SINGLE_PASS_CONFIGS = {
    "same_bank": {"require_same_bank": True},
    "no_cross_level_L1": {"allow_cross_level": False,
                          "cim_levels": ("L1",)},
}


def load_arrays(name: str) -> Dict[str, np.ndarray]:
    """Every array of one workload's fixture file."""
    if name not in CATEGORY:
        raise KeyError(f"unknown workload {name!r}; known: {WORKLOADS}")
    with np.load(FIXTURE_DIR / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def load_structural(name: str, device="cuda") -> StructuralTrace:
    """The reference's structural trace of workload ``name`` on ``device``
    (the oracle: the engine traces the port's program instead)."""
    dev = resolve_device(device)
    arrays = load_arrays(name)
    n_out = int(arrays["meta_n_outputs"][0])
    return StructuralTrace(
        ColumnarTrace.from_arrays(arrays, device=dev),
        [torch.from_numpy(arrays[f"out_{i}"]) for i in range(n_out)])


def reference_reports() -> dict:
    """The golden reports (see module docstring)."""
    return json.loads(REPORTS_PATH.read_text())


def reference_records() -> dict:
    """The reference's sweep records and adaptive run (see module
    docstring)."""
    return json.loads(RECORDS_PATH.read_text())


def reference_sampled() -> dict:
    """The committed reference sampled pipeline (see module doc)."""
    return json.loads(SAMPLED_PATH.read_text())


def reference_single_pass() -> dict:
    """The committed reference single-pass records and example lines
    (see module doc)."""
    return json.loads(SINGLE_PASS_PATH.read_text())


def candidate_tuple(c) -> tuple:
    """Every field of one ``Candidate`` of either package."""
    return (c.root_seq, tuple(c.op_seqs), tuple(c.op_classes),
            tuple(c.load_seqs), tuple(c.store_seqs), c.level, c.bank,
            c.moves, c.internal_edges, c.added_loads, c.memval_leaves,
            c.dram_fills)


def candidate_digest(candidates) -> str:
    """sha256 of the candidates' fields, in order, as JSON."""
    return hashlib.sha256(json.dumps(
        [candidate_tuple(c) for c in candidates]).encode()).hexdigest()


def single_pass_records(workload: str, config: str, result,
                        reports: Dict[str, SystemReport]) -> List[dict]:
    """The single-pass fixture's records of one (workload, config): one
    per technology, ``reports`` mapping tech -> report of either
    package."""
    digest = candidate_digest(result.candidates)
    return [{"workload": workload, "config": config, "tech": tech,
             "digest": digest, "claimed": len(result.claimed),
             **report_record(rep)} for tech, rep in reports.items()]


_TIMING = re.compile(r"\s+\(\d+(\.\d+)?s\)$")


def example_lines(text: str) -> List[str]:
    """An example's printed lines as the fixture holds them: without the
    line naming the device and without the timing in brackets."""
    return [_TIMING.sub("", line) for line in text.splitlines()
            if not line.startswith("device:")]


def column_digests(columns: Dict[str, np.ndarray]) -> Dict[str, list]:
    """``[dtype, shape, sha256 of the bytes]`` per column of a
    ``to_arrays()`` dict."""
    out = {}
    for name in sorted(columns):
        a = np.ascontiguousarray(columns[name])
        out[name] = [a.dtype.str, list(a.shape),
                     hashlib.sha256(a.tobytes()).hexdigest()]
    return out


def sampled_summary(ss, est) -> dict:
    """What the sampled fixture holds of one sampled pipeline run: the
    plan, the marks, the windowed columns' row count and digests, and the
    estimate, as JSON values.  ``ss`` is a ``SampledStructural`` and
    ``est`` a ``SampledEstimate`` of either package."""
    plan = ss.plan
    return json.loads(json.dumps({
        "plan": {"interval": plan.interval,
                 "total_virtual": plan.total_virtual,
                 "n_intervals": plan.n_intervals, "full": plan.full,
                 "picks": [list(p) for p in plan.picks],
                 "windows": [list(w) for w in plan.windows()],
                 "weights": plan.weights().tolist()},
        "marks": [list(m) for m in ss.marks],
        "measured": list(ss.measured),
        "rows": int(len(ss.columns["col_op"])),
        "columns": column_digests(ss.columns),
        "estimate": {"totals": est.totals, "metrics": est.metrics,
                     "ci": est.ci, "n_windows": est.n_windows,
                     "n_intervals": est.n_intervals},
    }, default=float))


def report_record(rep: SystemReport) -> Dict[str, float]:
    """The compared fields of one priced design point."""
    return {f: getattr(rep, f) for f in RECORD_FIELDS}


def design_point_space(workloads: Sequence[str] = WORKLOADS):
    """The golden reports' design points as one ``SweepSpace``: its
    enumeration (workload, then :data:`CACHES`, :data:`LEVEL_SETS`,
    :data:`TECHS`) is the golden file's record order."""
    return SweepSpace(workloads=tuple(workloads), caches=tuple(CACHES),
                      cim_levels=tuple(LEVEL_SETS), techs=TECHS)


def engine_design_points(engine, results
                         ) -> Dict[str, Tuple[Dict[tuple, dict],
                                              Dict[str, Dict[str, int]]]]:
    """The golden file's view of ``engine.run(design_point_space(...))``.

    Per workload: its records keyed by (cache, level set, tech), each with
    :data:`RECORD_FIELDS` (``n_offloaded`` from the engine's memoized
    selection), and the replay counters per cache, read from the engine's
    memoized traces."""
    level_name = {"+".join(v): k for k, v in LEVEL_SETS.items()}
    out: Dict[str, Tuple[Dict[tuple, dict], Dict[str, Dict[str, int]]]] = {}
    for rec in results:
        records, counters = out.setdefault(rec.workload, ({}, {}))
        cache = CacheOption.of(rec.cache)
        lv = level_name[rec.cim_levels]
        cfg = OffloadConfig(cim_levels=LEVEL_SETS[lv])
        _, shaped = engine.analysis.offload(rec.workload, cache, cfg)
        records[(rec.cache, lv, rec.tech)] = {
            "cache": rec.cache, "cim_levels": lv, "tech": rec.tech,
            **{f: getattr(rec, f) for f in RECORD_FIELDS
               if f != "n_offloaded"},
            "n_offloaded": shaped.n_offloaded}
        if rec.cache not in counters:
            counters[rec.cache] = engine.analysis.trace(
                rec.workload, cache).cache.counters()
    return out


def golden_by_key(golden_records: List[dict]) -> Dict[tuple, dict]:
    """The golden records of one workload keyed by (cache, level set,
    tech)."""
    return {(r["cache"], r["cim_levels"], r["tech"]): r
            for r in golden_records}
