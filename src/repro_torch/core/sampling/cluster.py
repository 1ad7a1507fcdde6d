"""Interval clustering: SimPoint-style phases or contiguous strata.

Twin of ``repro/core/sampling/cluster.py``, in float64 numpy on the host with
the reference's generators and order of summation, so plans and estimates
come out ``==``.

Turns a skim pass (:class:`~repro_torch.core.sampling.machines.SkimResult`) into
a :class:`SamplePlan`: every interval assigned to a cluster, ``budget``
representative windows picked across clusters proportionally to cluster
size (each non-empty cluster gets at least one), picks drawn uniformly
without replacement inside their cluster.  The estimator then weighs each
sampled window by ``L_c / m_c`` (intervals in its cluster over windows
sampled from it) — the classic stratified expansion estimator.

``phase`` mode runs a small numpy k-means (k-means++ init, deterministic
under the spec's seed) over row-normalized feature vectors; ``stratified``
mode skips the features entirely and uses contiguous equal strata, which
is both the fallback when phases are degenerate and the mode whose
unbiasedness the property tests pin down.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.sampling.machines import SkimResult
from repro_torch.core.sampling.spec import SamplingSpec


@dataclasses.dataclass
class SamplePlan:
    """Which windows to trace, and how to weigh them back up."""
    interval: int
    total_virtual: int
    mode: str
    cluster_of: np.ndarray                  # [n_intervals] cluster id
    picks: Tuple[Tuple[int, int], ...]      # (interval idx, cluster), sorted
    #: budget covered every interval: one full window, weight 1 — the
    #: traced stream is byte-identical to exact mode (no cold windows)
    full: bool = False

    @property
    def n_intervals(self) -> int:
        return len(self.cluster_of)

    @property
    def n_windows(self) -> int:
        return 1 if self.full else len(self.picks)

    def windows(self) -> List[Tuple[int, int]]:
        """Virtual ``[lo, hi)`` ranges of the picked windows, in order."""
        if self.full:
            return [(0, self.total_virtual)]
        iv = self.interval
        return [(p * iv, min((p + 1) * iv, self.total_virtual))
                for p, _ in self.picks]

    def weights(self) -> np.ndarray:
        """Expansion weight per pick: ``L_c / m_c`` of its cluster."""
        if self.full:
            return np.ones(1)
        sizes = np.bincount(self.cluster_of)
        m = np.zeros_like(sizes)
        for _, c in self.picks:
            m[c] += 1
        return np.array([sizes[c] / m[c] for _, c in self.picks], float)

    def pick_clusters(self) -> np.ndarray:
        if self.full:
            return np.zeros(1, np.int64)
        return np.array([c for _, c in self.picks], np.int64)


# ----------------------------------------------------------------- k-means
def _kmeans(X: np.ndarray, k: int, rng: np.random.Generator,
            iters: int = 25) -> np.ndarray:
    n = X.shape[0]
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[int(rng.integers(n))]
    d2 = ((X - centers[0]) ** 2).sum(1)
    for i in range(1, k):                       # k-means++ seeding
        s = d2.sum()
        idx = int(rng.choice(n, p=d2 / s)) if s > 0 else int(rng.integers(n))
        centers[i] = X[idx]
        d2 = np.minimum(d2, ((X - centers[i]) ** 2).sum(1))
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        dist = ((X[:, None, :] - centers[None]) ** 2).sum(2)
        assign = dist.argmin(1)
        moved = False
        for c in range(k):
            members = assign == c
            if members.any():
                new = X[members].mean(0)
            else:                               # reseed empty clusters
                new = X[int(rng.integers(n))]
            if not np.allclose(new, centers[c]):
                moved = True
            centers[c] = new
        if not moved:
            break
    return ((X[:, None, :] - centers[None]) ** 2).sum(2).argmin(1)


def _compact_labels(labels: np.ndarray) -> np.ndarray:
    """Relabel to dense 0..k'-1 (k-means can leave empty clusters)."""
    uniq = np.unique(labels)
    remap = np.zeros(labels.max() + 1, np.int64)
    remap[uniq] = np.arange(len(uniq))
    return remap[labels]


def _alloc_reps(sizes: np.ndarray, budget: int) -> np.ndarray:
    """Windows per cluster: proportional to size, >=1 each, capped at the
    cluster size, summing to <= budget (largest-remainder rounding)."""
    sizes = np.asarray(sizes, np.int64)
    k = len(sizes)
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
            if not grew:                        # every cluster saturated
                break
    return m


def build_plan(skim: SkimResult, spec: SamplingSpec) -> SamplePlan:
    """Cluster the skimmed intervals and pick the windows to trace."""
    if spec.is_exact:
        raise ValueError("exact mode has no sampling plan")
    n_int = skim.n_intervals
    if spec.budget >= n_int:
        # the budget covers every interval: trace one full window instead
        # of n_int cold ones — byte-identical to exact, zero estimator
        # error, and no window-boundary dependency truncation.  Sampling
        # proper only engages when the trace outgrows interval * budget.
        return SamplePlan(interval=skim.interval,
                          total_virtual=skim.total_virtual,
                          mode=spec.mode,
                          cluster_of=np.zeros(n_int, np.int64),
                          picks=((0, 0),), full=True)
    budget = min(spec.budget, n_int)
    rng = np.random.default_rng(spec.seed)

    if spec.mode == "phase" and n_int > 2:
        X = np.asarray(skim.features, float)
        norms = X.sum(1, keepdims=True)
        X = X / np.maximum(norms, 1.0)          # op-mix proportions
        k = max(1, min(budget, n_int, 64) // 2) or 1
        labels = _compact_labels(_kmeans(X, k, rng)) if k > 1 \
            else np.zeros(n_int, np.int64)
    else:                                       # stratified (and tiny inputs)
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
    return SamplePlan(interval=skim.interval,
                      total_virtual=skim.total_virtual,
                      mode=spec.mode, cluster_of=labels,
                      picks=tuple(picks))
