"""Structured sweep results: flat records + JSON / markdown reporting.

Twin of ``repro/dse/results.py``: records built from the port's
:class:`~repro_torch.core.profiler.SystemReport`, with ``to_json`` and
``to_markdown`` giving the reference's bytes.

One :class:`SweepRecord` per evaluated
:class:`~repro_torch.dse.space.SweepPoint`, carrying the paper's reported metrics (energy improvement, speedup, MACR,
Table VI ratios) plus the raw energies/cycles so derived normalizations
(e.g. Fig. 16's "vs the SRAM non-CiM baseline") can be computed after the
sweep without re-running anything.  Records are plain floats/strings —
picklable across the process-pool boundary and JSON-able as-is — and each
carries the name of the host model it was priced under, so host-axis
sweeps (``SweepSpace(hosts=...)``) stay distinguishable all the way into
the Pareto/markdown reports.

:class:`SweepResults` wraps the record list (always in SweepPoint order,
whatever executor scheduling produced it) together with the run's cost
accounting: ``stats`` holds the analysis-cache build/hit counters — and,
when the engine is backed by a persistent
:class:`~repro_torch.dse.store.AnalysisStore`, the store's hit/write counters —
which is how benchmarks *prove* a warm sweep did zero trace builds.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.host_model import DEFAULT_HOST, HostModel
from repro_torch.core.profiler import SystemReport
from repro_torch.dse.pareto import pareto_front
from repro_torch.dse.space import SweepPoint


@dataclasses.dataclass(frozen=True)
class SweepRecord:
    """One priced design point (metrics are plain floats — picklable and
    JSON-able, no live trace/model objects)."""
    index: int
    workload: str
    cache: str
    cim_levels: str                      # "L1+L2" style
    tech: str
    cim_set: str
    host: str                            # host-model preset it was priced under
    energy_improvement: float
    speedup: float
    macr: float
    macr_l1: float
    base_energy_pj: float
    cim_energy_pj: float
    base_cycles: float
    cim_cycles: float
    base_runtime_ms: float               # cycles / host clock (freq_ghz)
    cim_runtime_ms: float
    processor_ratio: float
    cache_ratio: float
    n_instructions: int
    n_mem_accesses: int
    n_candidates: int
    n_cim_ops: int
    # provenance: which refinement round priced this point (0 = the coarse
    # seed sweep; one-shot sweeps leave it 0)
    round: int = 0
    # which analysis backend priced it: the port has only the CiM one
    backend: str = "cim"
    # sampling identity: "exact", or the SamplingSpec.key() the metrics
    # were estimated under; sampled records carry bootstrap CI half-widths
    # for the three headline metrics (repro_torch.core.sampling.estimate)
    sampling: str = "exact"
    energy_improvement_ci: float = 0.0
    speedup_ci: float = 0.0
    macr_ci: float = 0.0

    _SAMPLING_KEYS = ("sampling", "energy_improvement_ci", "speedup_ci",
                      "macr_ci")

    @classmethod
    def from_report(cls, point: SweepPoint, rep: SystemReport,
                    host: Optional[HostModel] = None,
                    host_name: Optional[str] = None) -> "SweepRecord":
        """``host`` is the model the report was priced under (wall-clock
        runtimes come from its clock); ``host_name`` overrides the record
        label (e.g. a HostOption's collision-safe name)."""
        if host is None:
            host = (point.host.model if point.host is not None
                    else DEFAULT_HOST)
        if host_name is None:
            host_name = (point.host.name if point.host is not None
                         else host.name)
        return cls(
            index=point.index,
            workload=point.workload,
            cache=point.cache.name,
            cim_levels="+".join(point.cim_levels),
            tech=point.tech,
            cim_set=point.cim_set,
            host=host_name,
            energy_improvement=rep.energy_improvement,
            speedup=rep.speedup,
            macr=rep.macr,
            macr_l1=rep.macr_l1,
            base_energy_pj=rep.base.total,
            cim_energy_pj=rep.cim.total,
            base_cycles=rep.base_cycles,
            cim_cycles=rep.cim_cycles,
            base_runtime_ms=host.runtime_ms(rep.base_cycles),
            cim_runtime_ms=host.runtime_ms(rep.cim_cycles),
            processor_ratio=rep.processor_ratio,
            cache_ratio=rep.cache_ratio,
            n_instructions=rep.n_instructions,
            n_mem_accesses=rep.n_mem_accesses,
            n_candidates=rep.n_candidates,
            n_cim_ops=rep.n_cim_ops,
        )

    def to_dict(self) -> Dict[str, Any]:
        """Exact records drop the sampling columns entirely, so every
        pre-sampling artifact (fig12–17 JSON, sweep reports) stays
        byte-identical; sampled records carry them."""
        d = dataclasses.asdict(self)
        if self.sampling == "exact":
            for k in self._SAMPLING_KEYS:
                del d[k]
        return d

    @property
    def config_label(self) -> str:
        return (f"{self.cache}/cim@{self.cim_levels}/{self.tech}"
                f"/{self.cim_set}/{self.host}")


_REPORT_COLUMNS = ("workload", "cache", "cim_levels", "tech", "host",
                   "energy_improvement", "speedup", "macr")


@dataclasses.dataclass
class SweepResults:
    """All records of one sweep, in SweepPoint order, plus run metadata."""
    records: List[SweepRecord]
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    elapsed_s: float = 0.0

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    # ------------------------------------------------------------- merging
    def merge(self, other: "SweepResults") -> "SweepResults":
        """Combine two result sets into one (multi-round reports).

        Records are concatenated and re-indexed to one contiguous 0..n-1
        sequence (each record's ``round`` tag keeps its provenance);
        ``stats`` counters are summed key-wise over the union of keys, so a
        merged report never under-counts work one side did and the other
        didn't (``to_markdown``'s ``trace_builds`` line stays the true
        total, not a ``'?'`` fallback); ``elapsed_s`` adds.  Neither input
        is mutated.  Used by :class:`repro_torch.dse.adaptive.AdaptiveDSE` to
        accumulate refinement rounds.
        """
        records = [dataclasses.replace(r, index=i) for i, r in
                   enumerate(list(self.records) + list(other.records))]
        stats = dict(self.stats)
        for k, v in other.stats.items():
            stats[k] = stats.get(k, 0) + v
        return SweepResults(records=records, stats=stats,
                            elapsed_s=self.elapsed_s + other.elapsed_s)

    # ------------------------------------------------------------- queries
    def best(self, metric: str = "energy_improvement",
             workload: Optional[str] = None) -> SweepRecord:
        """Argmax record over ``metric`` (ties broken toward the earliest
        point).  Records with a non-finite metric (NaN, ±inf) are excluded
        — ``max()`` over NaN is order-dependent garbage — and all-NaN
        pools raise rather than return a degenerate winner."""
        pool = [r for r in self.records
                if workload is None or r.workload == workload]
        if not pool:
            raise ValueError(f"no records for workload={workload!r}")
        finite = [r for r in pool if math.isfinite(getattr(r, metric))]
        if not finite:
            raise ValueError(f"no finite {metric!r} values for "
                             f"workload={workload!r}")
        return max(finite, key=lambda r: (getattr(r, metric), -r.index))

    def group_by(self, field: str) -> Dict[str, List[SweepRecord]]:
        out: Dict[str, List[SweepRecord]] = {}
        for r in self.records:
            out.setdefault(getattr(r, field), []).append(r)
        return out

    def pareto(self, objectives: Sequence = ("energy_improvement", "speedup"),
               per_workload: bool = True) -> List[SweepRecord]:
        """Non-dominated records over ``objectives`` (maximized by default;
        see :func:`repro_torch.dse.pareto.pareto_front` for (name, "min")
        pairs)."""
        if not per_workload:
            return pareto_front(self.records, objectives)
        out: List[SweepRecord] = []
        for recs in self.group_by("workload").values():
            out.extend(pareto_front(recs, objectives))
        return sorted(out, key=lambda r: r.index)

    # ----------------------------------------------------------- reporting
    def rows(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self.records]

    def to_json(self, path: Optional[pathlib.Path] = None) -> str:
        doc = {"stats": self.stats, "elapsed_s": round(self.elapsed_s, 3),
               "n_records": len(self.records), "records": self.rows()}
        text = json.dumps(doc, indent=1)
        if path is not None:
            pathlib.Path(path).write_text(text)
        return text

    def to_markdown(self, columns: Sequence[str] = _REPORT_COLUMNS,
                    pareto_objectives: Sequence = ("energy_improvement",
                                                   "speedup")) -> str:
        """Human-readable sweep report: full table + per-workload Pareto set."""
        def fmt(v: Any) -> str:
            return f"{v:.3f}" if isinstance(v, float) else str(v)

        lines = ["# DSE sweep report", "",
                 f"{len(self.records)} design points; "
                 f"{self.stats.get('trace_builds', '?')} trace analyses "
                 f"({self.stats.get('trace_hits', 0)} cache hits); "
                 f"{self.elapsed_s:.1f}s", "",
                 "| " + " | ".join(columns) + " |",
                 "|" + "|".join("---" for _ in columns) + "|"]
        for r in self.records:
            lines.append("| " + " | ".join(fmt(getattr(r, c))
                                           for c in columns) + " |")
        front = self.pareto(pareto_objectives)
        names = [o if isinstance(o, str) else o[0] for o in pareto_objectives]
        lines += ["", f"## Pareto frontier ({' vs '.join(names)}, "
                      "per workload)", ""]
        for r in front:
            vals = ", ".join(f"{n}={fmt(getattr(r, n))}" for n in names)
            lines.append(f"- **{r.workload}** {r.config_label}: {vals}")
        return "\n".join(lines) + "\n"
