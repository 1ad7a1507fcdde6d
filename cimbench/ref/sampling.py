"""The reference's sampled pipeline: plan, warm-chained replay of the
windowed trace, per-window Algorithm 1 and pricing, and the
cluster-weighted bootstrap estimate.

Copied from the original package's ``core/sampling/{spec, cluster,
estimate, pipeline}.py`` (the stratified plan only; the feature-driven
``phase`` plan is not used by the benchmark).  The windowed trace itself
is not traced here: the reference takes the program's windowed columns
after checking them against the original VM's columns for the same plan,
held as digests in ``sampled_windows.json`` (:func:`window_digests`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from cimbench.ref.cache import CacheHierarchy
from cimbench.ref.columnar import ColumnarTrace
from cimbench.ref.isa import OP_STORE
from cimbench.ref.offload import OffloadConfig, analyze_trace
from cimbench.ref.profiler import SystemReport, profile_system
from cimbench.ref.reshape import reshape
from cimbench.ref.trace import TraceResult

WINDOWS_PATH = pathlib.Path(__file__).resolve().parent / "sampled_windows.json"


# ------------------------------------------------------------------ spec
@dataclasses.dataclass(frozen=True)
class Spec:
    mode: str
    interval: int
    budget: int
    warmup: int
    seed: int
    confidence: float = 0.95
    n_boot: int = 200

    def key(self) -> str:
        k = f"{self.mode}:i{self.interval}:b{self.budget}:s{self.seed}"
        if self.warmup != 2048:
            k += f":w{self.warmup}"
        if self.confidence != 0.95:
            k += f":c{self.confidence:g}"
        if self.n_boot != 200:
            k += f":r{self.n_boot}"
        return k


# ------------------------------------------------------------------ plan
@dataclasses.dataclass
class Plan:
    interval: int
    total_virtual: int
    cluster_of: np.ndarray
    picks: Tuple[Tuple[int, int], ...]

    @property
    def n_windows(self) -> int:
        return len(self.picks)

    @property
    def n_intervals(self) -> int:
        return len(self.cluster_of)

    def windows(self) -> List[Tuple[int, int]]:
        iv = self.interval
        return [(p * iv, min((p + 1) * iv, self.total_virtual))
                for p, _ in self.picks]

    def weights(self) -> np.ndarray:
        sizes = np.bincount(self.cluster_of)
        m = np.zeros_like(sizes)
        for _, c in self.picks:
            m[c] += 1
        return np.array([sizes[c] / m[c] for _, c in self.picks], float)

    def pick_clusters(self) -> np.ndarray:
        return np.array([c for _, c in self.picks], np.int64)


def _alloc_reps(sizes: np.ndarray, budget: int) -> np.ndarray:
    sizes = np.asarray(sizes, np.int64)
    raw = budget * sizes / sizes.sum()
    m = np.maximum(1, np.floor(raw).astype(np.int64))
    m = np.minimum(m, sizes)
    rem = budget - int(m.sum())
    if rem > 0:
        order = np.argsort(-(raw - np.floor(raw)))
        while rem > 0:
            grew = False
            for i in order:
                if rem <= 0:
                    break
                if m[i] < sizes[i]:
                    m[i] += 1
                    rem -= 1
                    grew = True
            if not grew:
                break
    return m


def stratified_plan(total_virtual: int, spec: Spec) -> Plan:
    """Contiguous equal strata, ``budget`` picks spread over them, drawn
    without replacement under the spec's seed (a budget below the
    interval count: sampling proper)."""
    n_int = -(-total_virtual // spec.interval)
    if spec.mode != "stratified" or spec.budget >= n_int:
        raise ValueError("the reference plans stratified sampling below "
                         "full coverage only")
    budget = spec.budget
    rng = np.random.default_rng(spec.seed)
    k = max(1, min(budget // 2, n_int)) if budget > 1 else 1
    labels = np.minimum(np.arange(n_int) * k // n_int, k - 1)
    sizes = np.bincount(labels)
    reps = _alloc_reps(sizes, budget)
    picks: List[Tuple[int, int]] = []
    for c in range(len(sizes)):
        members = np.flatnonzero(labels == c)
        chosen = rng.choice(members, size=int(reps[c]), replace=False)
        picks.extend((int(i), int(c)) for i in chosen)
    picks.sort()
    return Plan(spec.interval, total_virtual, labels, tuple(picks))


def window_digests(workload: str, seed: int) -> Dict:
    """The original VM's windowed trace of ``workload`` for ``seed``'s
    plan: marks, measured windows, rows, ``[dtype, shape, sha256]`` per
    column, and the program's virtual instructions; ``None`` for a seed
    (or program) it does not hold."""
    doc = json.loads(WINDOWS_PATH.read_text()).get(workload)
    entry = None if doc is None else doc["seeds"].get(str(seed))
    if entry is None:
        return None
    return dict(entry, total_virtual=doc["total_virtual"])


def column_digests(columns: Dict[str, np.ndarray]) -> Dict[str, list]:
    out = {}
    for name in sorted(columns):
        a = np.ascontiguousarray(columns[name])
        out[name] = [a.dtype.str, list(a.shape),
                     hashlib.sha256(a.tobytes()).hexdigest()]
    return out


# ------------------------------------------------------------------ layers
def slice_columns(ct: ColumnarTrace, lo: int, hi: int) -> ColumnarTrace:
    so = ct.src_off
    slo, shi = int(so[lo]), int(so[hi])
    return ColumnarTrace(
        hi - lo, ct.op[lo:hi], ct.unit[lo:hi], ct.dtype[lo:hi],
        ct.dst[lo:hi], ct.addr[lo:hi], ct.size[lo:hi], ct.level[lo:hi],
        ct.hit[lo:hi], ct.bank[lo:hi], ct.mshr[lo:hi],
        so[lo:hi + 1] - slo, ct.src_tag[slo:shi], ct.src_val[slo:shi],
        ct.src_kind[slo:shi], ct.n_regs)


def replay(columns: Dict[str, np.ndarray], levels
           ) -> Tuple[ColumnarTrace, CacheHierarchy]:
    """The whole windowed trace through one hierarchy, in virtual order."""
    ct = ColumnarTrace.from_arrays(columns)
    hier = CacheHierarchy(levels)
    mem_idx = np.flatnonzero(ct.mem_mask)
    lvl, hit, bank, mshr = hier.replay(ct.addr[mem_idx],
                                       ct.op[mem_idx] == OP_STORE)
    level_col = np.zeros(ct.n, np.int8)
    hit_col = np.full(ct.n, -1, np.int8)
    bank_col = np.full(ct.n, -1, np.int16)
    mshr_col = np.zeros(ct.n, bool)
    level_col[mem_idx] = lvl
    hit_col[mem_idx] = hit
    bank_col[mem_idx] = bank
    mshr_col[mem_idx] = mshr
    return ct.with_mem_results(level_col, hit_col, bank_col, mshr_col), hier


def windows(full: ColumnarTrace, hier: CacheHierarchy,
            marks: Sequence[Tuple[int, int, int]]) -> List[TraceResult]:
    return [TraceResult(slice_columns(full, lo, hi), hier, [])
            for _, lo, hi in marks]


def select(trs: Sequence[TraceResult], cfg: OffloadConfig) -> List[tuple]:
    out = []
    for tr in trs:
        an = analyze_trace(tr)
        result = an.select(cfg)
        out.append((result, reshape(an.trace, result)))
    return out


# ------------------------------------------------------------------ estimate
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


def estimate(Y: np.ndarray, plan: Plan, spec: Spec) -> Dict:
    """Totals, metrics and bootstrap CI half-widths from the per-window
    component rows (plan pick order)."""
    Y = np.asarray(Y, float)
    w = plan.weights()
    totals_vec = (w[:, None] * Y).sum(0)
    metrics = _metrics(totals_vec)
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
    return {"totals": {name: float(totals_vec[i])
                       for i, name in enumerate(COMPONENTS)},
            "metrics": metrics, "ci": ci}


def price(trs: Sequence[TraceResult], selections: Sequence[tuple],
          plan: Plan, spec: Spec, tech: str, host, float_type=float) -> Dict:
    reports = [profile_system(tr, tech=tech, host=host, offload=result,
                              reshaped=shaped, float_type=float_type)
               for tr, (result, shaped) in zip(trs, selections)]
    return estimate(np.stack([window_components(r) for r in reports]),
                    plan, spec)
