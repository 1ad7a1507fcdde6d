"""Committed structural traces of the 17 Table-IV workloads.

Stands in for ``repro/workloads/__init__.py::build`` plus the reference's
trace VM until the port's trace frontend lands (ROADMAP Queue 1), and goes
away with it.  ``fixtures/<NAME>.npz`` holds, for each workload, the
reference trace's layer-1 columns (``ColumnarTrace.to_arrays()``), the
program outputs (``out_<i>``) and ``meta_*`` entries: the trace-VM and
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
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import L1_32K, L1_64K, L2_256K, L2_2M
from repro_torch.core.columnar import ColumnarTrace, resolve_device
from repro_torch.core.offload import OffloadConfig, select_candidates
from repro_torch.core.profiler import SystemReport, profile_system
from repro_torch.core.reshape import reshape
from repro_torch.core.trace import (StructuralTrace,
                                    attach_cache_results_batch)

FIXTURE_DIR = pathlib.Path(__file__).resolve().parent / "fixtures"
REPORTS_PATH = FIXTURE_DIR / "reference_reports.json"
ARTIFACTS_DIR = FIXTURE_DIR / "reference_artifacts"
RECORDS_PATH = ARTIFACTS_DIR / "records.json"


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


def load_arrays(name: str) -> Dict[str, np.ndarray]:
    """Every array of one workload's fixture file."""
    if name not in CATEGORY:
        raise KeyError(f"unknown workload {name!r}; known: {WORKLOADS}")
    with np.load(FIXTURE_DIR / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def load_structural(name: str, device="cuda") -> StructuralTrace:
    """The reference's structural trace of workload ``name`` on ``device``."""
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


def report_record(rep: SystemReport) -> Dict[str, float]:
    """The compared fields of one priced design point."""
    return {f: getattr(rep, f) for f in RECORD_FIELDS}


def price_design_points(st: StructuralTrace, device="cuda",
                        stage_seconds: Optional[Dict[str, float]] = None
                        ) -> Tuple[List[dict], Dict[str, Dict[str, int]]]:
    """Price every design point of one workload on ``device``.

    One batched replay over :data:`CACHES`, one selection per level set,
    one pricing per technology.  Returns the records (with their design
    point) in the golden file's order and the replay counters per cache.
    ``stage_seconds``, when given, accumulates host wall seconds per stage
    (each stage ends by reading its result on the host)."""
    stage = stage_seconds if stage_seconds is not None else {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        stage[name] = stage.get(name, 0.0) + time.perf_counter() - t0
        return out

    trs = timed("replay", attach_cache_results_batch, st,
                list(CACHES.values()), device=device)
    records: List[dict] = []
    counters: Dict[str, Dict[str, int]] = {}
    for cache, tr in zip(CACHES, trs):
        counters[cache] = tr.cache.counters()
        for lv_name, levels in LEVEL_SETS.items():
            cfg = OffloadConfig(cim_levels=levels)
            res = timed("select", select_candidates, tr.trace, cfg,
                        device=device)
            shaped = timed("reshape", reshape, tr.trace, res)
            for tech in TECHS:
                rep = timed("price", profile_system, tr, cfg, tech,
                            offload=res, reshaped=shaped, device=device)
                records.append({"cache": cache, "cim_levels": lv_name,
                                "tech": tech, **report_record(rep)})
    return records, counters
