"""Shared runner utilities: one DSE engine + CSV/JSON emission.

Twin of ``benchmarks/common.py``.  Every artifact module reproduces one
paper table/figure and exposes ``run() -> list[dict]``;
:mod:`repro_torch.bench.run` executes them and writes each artifact's CSV
and JSON, byte for byte what ``python -m benchmarks.run`` writes.

All trace-driven artifacts share a single
:class:`repro_torch.dse.AnalysisCache` (via :func:`engine` /
:func:`cached_trace`), so across a full run each (workload, cache-config)
pair is replayed and analyzed once, on the device :func:`configure` set
(``cuda`` unless told otherwise).  ``EVA_CIM_CACHE_DIR=/some/dir`` backs
that cache with a persistent :class:`repro_torch.dse.AnalysisStore`.
"""
from __future__ import annotations

import csv
import json
import os
import pathlib
from typing import List, Optional, Tuple

from repro_torch.core.cache import CacheConfig
from repro_torch.dse import CacheOption, DSEEngine

#: default output directory: ``build/bench_torch/`` at the root of the
#: checkout (git-ignored), never the reference's ``benchmarks/artifacts/``
DEFAULT_OUT = (pathlib.Path(__file__).resolve().parents[3] / "build"
               / "bench_torch")

# The nine Fig. 13–15 sweep benchmarks (paper's per-figure subset).
SWEEP_BENCHES = ("NB", "DT", "KM", "LCS", "BFS", "SSSP", "CCOMP", "hmmer",
                 "mcf")

_ENGINE: Optional[DSEEngine] = None
_DEVICE = "cuda"
_OUT = DEFAULT_OUT


def configure(device="cuda", out=DEFAULT_OUT) -> None:
    """Set the device and output directory of the artifacts that follow;
    drops the process's engine, so the next :func:`engine` builds anew."""
    global _ENGINE, _DEVICE, _OUT
    _ENGINE, _DEVICE, _OUT = None, device, pathlib.Path(out)


def engine() -> DSEEngine:
    """Process-wide sweep engine (one shared analysis cache on the
    configured device; backed by a persistent store when
    ``EVA_CIM_CACHE_DIR`` is set)."""
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = DSEEngine(store=os.environ.get("EVA_CIM_CACHE_DIR") or None,
                            device=_DEVICE)
    return _ENGINE


def device():
    """The engine's device, for the artifacts that call the core directly."""
    return engine().device


def cached_trace(name: str,
                 cache_levels: Optional[Tuple[CacheConfig, ...]] = None):
    """Memoized ``TraceResult`` for a workload (engine-backed)."""
    from repro_torch.core.cache import L1_32K, L2_256K
    option = CacheOption.of(cache_levels if cache_levels is not None
                            else (L1_32K, L2_256K))
    return engine().analysis.trace(name, option)


def out_dir() -> pathlib.Path:
    """The directory :func:`configure` set for the artifacts."""
    return _OUT


def emit(name: str, rows: List[dict]) -> pathlib.Path:
    _OUT.mkdir(parents=True, exist_ok=True)
    path = _OUT / f"{name}.csv"
    if rows:
        fields = list(dict.fromkeys(k for r in rows for k in r))
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, restval="")
            w.writeheader()
            w.writerows(rows)
    (_OUT / f"{name}.json").write_text(json.dumps(rows, indent=1, default=str))
    return path


def banner(title: str) -> None:
    print(f"\n=== {title} " + "=" * max(0, 66 - len(title)), flush=True)
