"""Cluster-weighted whole-program estimates with bootstrap error bars.

Twin of ``repro/core/sampling/estimate.py``, in float64 numpy on the host with
the reference's generators and order of summation, so plans and estimates
come out ``==``.

Every priced window ``j`` contributes a component vector ``y_j`` of the
*additive* quantities a :class:`~repro_torch.core.profiler.SystemReport` is made
of (energies, cycles, covered/total access counts — never the ratios).
The whole-program total of each component is the stratified expansion

    T_hat = sum_c (L_c / m_c) * sum_{j in c} y_j

(cluster ``c`` holds ``L_c`` intervals, ``m_c`` of them sampled), and the
reported metrics are ratios of estimated totals — energy improvement
``T[base] / T[cim]``, MACR ``T[covered] / T[accesses]``, and so on.  This
is the textbook ratio-of-totals estimator: consistent, with O(1/n) bias
that the property tests bound empirically.

Error bars are bootstrap percentile intervals: windows are resampled with
replacement *within their cluster* (``n_boot`` times), the metric is
recomputed per resample, and the CI half-width at the spec's confidence
level is attached to the record.  Clusters with a single sampled window
contribute no variance to the bootstrap — a wider ``budget`` (>= 2 windows
per cluster) is what makes the error bars honest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.profiler import SystemReport
from repro_torch.core.sampling.cluster import SamplePlan
from repro_torch.core.sampling.spec import SamplingSpec

#: the additive component vector (order is the contract between
#: :func:`window_components` and :func:`estimate`)
COMPONENTS = (
    "base_energy", "cim_energy",
    "base_processor", "cim_processor",
    "base_memory", "cim_memory",
    "base_cycles", "cim_cycles",
    "macr_covered", "macr_l1_covered",
    "mem_accesses", "n_instructions", "n_candidates", "n_cim_ops",
)
_I = {name: i for i, name in enumerate(COMPONENTS)}


def window_components(rep: SystemReport) -> np.ndarray:
    """One window's additive contribution vector."""
    mem = float(rep.n_mem_accesses)
    return np.array([
        rep.base.total, rep.cim.total,
        rep.base.processor, rep.cim.processor,
        rep.base.caches + rep.base.dram, rep.cim.caches + rep.cim.dram,
        rep.base_cycles, rep.cim_cycles,
        rep.macr * mem, rep.macr_l1 * mem,
        mem, float(rep.n_instructions),
        float(rep.n_candidates), float(rep.n_cim_ops),
    ])


def _metrics(t: np.ndarray) -> Dict[str, float]:
    delta = t[_I["base_energy"]] - t[_I["cim_energy"]]
    return {
        "energy_improvement":
            t[_I["base_energy"]] / max(t[_I["cim_energy"]], 1e-9),
        "speedup": t[_I["base_cycles"]] / max(t[_I["cim_cycles"]], 1e-9),
        "macr": t[_I["macr_covered"]] / max(t[_I["mem_accesses"]], 1e-9),
        "macr_l1":
            t[_I["macr_l1_covered"]] / max(t[_I["mem_accesses"]], 1e-9),
        "processor_ratio": 0.0 if abs(delta) < 1e-12 else
            (t[_I["base_processor"]] - t[_I["cim_processor"]]) / delta,
        "cache_ratio": 0.0 if abs(delta) < 1e-12 else
            (t[_I["base_memory"]] - t[_I["cim_memory"]]) / delta,
    }


@dataclasses.dataclass
class SampledEstimate:
    """Whole-program estimate: totals, headline metrics, and CI half-widths
    (bootstrap percentile, at the spec's confidence) for the three metrics
    the sweep records carry error bars for."""
    totals: Dict[str, float]
    metrics: Dict[str, float]
    ci: Dict[str, float]
    n_windows: int
    n_intervals: int

    def total(self, name: str) -> float:
        return self.totals[name]


def estimate(Y: np.ndarray, plan: SamplePlan,
             spec: SamplingSpec) -> SampledEstimate:
    """Estimate whole-program metrics from per-window components.

    ``Y``: ``[n_windows, len(COMPONENTS)]`` in plan pick order.
    """
    Y = np.asarray(Y, float)
    if Y.shape[0] != plan.n_windows:
        raise ValueError(f"{Y.shape[0]} component rows for "
                         f"{plan.n_windows} planned windows")
    w = plan.weights()
    totals_vec = (w[:, None] * Y).sum(0)
    metrics = _metrics(totals_vec)

    # bootstrap: resample windows with replacement within each cluster
    rng = np.random.default_rng(spec.seed + 0x5A11)
    clusters = plan.pick_clusters()
    sizes = np.bincount(plan.cluster_of)
    groups = [np.flatnonzero(clusters == c) for c in range(len(sizes))
              if (clusters == c).any()]
    boot = {"energy_improvement": [], "speedup": [], "macr": []}
    for _ in range(spec.n_boot):
        t = np.zeros(len(COMPONENTS))
        for g in groups:
            take = g if len(g) == 1 else rng.choice(g, size=len(g))
            t += (w[take][:, None] * Y[take]).sum(0)
        mb = _metrics(t)
        for k in boot:
            boot[k].append(mb[k])
    alpha = 1.0 - spec.confidence
    ci = {}
    for k, vals in boot.items():
        lo, hi = np.percentile(vals, [100 * alpha / 2,
                                      100 * (1 - alpha / 2)])
        ci[k] = float(hi - lo) / 2.0
    return SampledEstimate(
        totals={name: float(totals_vec[i])
                for i, name in enumerate(COMPONENTS)},
        metrics=metrics, ci=ci,
        n_windows=plan.n_windows, n_intervals=plan.n_intervals)


def estimate_reports(reports: Sequence[SystemReport], plan: SamplePlan,
                     spec: SamplingSpec) -> SampledEstimate:
    """Convenience: stack per-window reports and estimate."""
    return estimate(np.stack([window_components(r) for r in reports]),
                    plan, spec)
