"""Machine-learning benchmarks (paper Table IV): NB, DT, SVM, LiR, KM.

Twin of ``repro/workloads/ml.py``: the same inputs from the same seeds,
and programs written op for op like the reference's, in plain batched
torch ops (see :mod:`repro_torch.workloads.lowering`)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.trace import scan
from repro_torch.workloads.lowering import F32, I32, astype, imm, wrap


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32))


# ----------------------------------------------------------------- NB
def build_nb(scale: int = 1):
    """Categorical naive Bayes inference: integer log-likelihood table
    lookups accumulated per class (gather + add chains)."""
    r = _rng(0)
    N, F, C, V = 8 * scale, 8, 4, 4
    x = _i32(r.integers(0, V, (N, F)))
    table = _i32(r.integers(-64, 0, (C, F, V)))
    prior = _i32(r.integers(-16, 0, (C,)))

    def nb(x, table, prior):
        xf = wrap(x, V)                                   # (N, F)
        c = torch.arange(C, dtype=I32)[None, :, None]
        f = torch.arange(F, dtype=I32)[None, None, :]
        vals = table[c, f, xf[:, None, :]]                # (N, C, F) gather
        scores = torch.sum(vals, 2) + prior
        return torch.argmax(scores, 1)

    return nb, (x, table, prior)


# ----------------------------------------------------------------- DT
def build_dt(scale: int = 1):
    """Decision-tree inference: depth-8 complete tree walked per sample
    (gather feature -> compare threshold -> branch index arithmetic)."""
    r = _rng(1)
    N, F, DEPTH = 16 * scale, 8, 8
    n_nodes = 2 ** DEPTH
    x = _i32(r.integers(0, 256, (N, F)))
    feat = _i32(r.integers(0, F, (n_nodes,)))
    thresh = _i32(r.integers(0, 256, (n_nodes,)))

    def dt(x, feat, thresh):
        rows = torch.arange(N, dtype=I32)

        def step(node, _):
            f = feat[wrap(node, n_nodes)]
            t = thresh[wrap(node, n_nodes)]
            go_right = x[rows, wrap(f, F)] > t
            node = imm(2) * node + 1 + astype(go_right, I32)
            node = torch.minimum(node, imm(n_nodes - 1))
            return node, None
        leaf, _ = scan(step, torch.zeros(N, dtype=I32), None, length=DEPTH)
        return leaf & 1                          # class = leaf parity

    return dt, (x, feat, thresh)


# ----------------------------------------------------------------- SVM
def build_svm(scale: int = 1):
    """Linear SVM: inference scores + one hinge-loss subgradient step."""
    r = _rng(2)
    N, F = 12 * scale, 12
    X = _f32(r.normal(size=(N, F)))
    y = _f32(r.choice([-1.0, 1.0], N))
    w = _f32(r.normal(size=(F,)) * 0.1)

    def svm(X, y, w):
        scores = torch.mv(X, w)                         # (N,)
        margin = y * scores
        active = astype(margin < 1.0, F32)              # hinge subgradient
        grad = -torch.mv(X.t(), active * y) / N + imm(0.01, F32) * w
        w2 = w - imm(0.1, F32) * grad
        preds = torch.sign(torch.mv(X, w2))
        acc_n = torch.sum(astype(preds == y, I32))
        return w2, acc_n

    return svm, (X, y, w)


# ----------------------------------------------------------------- LiR
def build_lir(scale: int = 1):
    """Linear regression: 4 full-batch gradient-descent steps."""
    r = _rng(3)
    N, F, STEPS = 12 * scale, 8, 4
    X = _f32(r.normal(size=(N, F)))
    yv = _f32(r.normal(size=(N,)))
    w0 = torch.zeros((F,), dtype=F32)

    def lir(X, yv, w0):
        def step(w, _):
            err = torch.mv(X, w) - yv
            grad = torch.mv(X.t(), err) / N
            return w - imm(0.05, F32) * grad, torch.sum(err * err)
        return scan(step, w0, None, length=STEPS)

    return lir, (X, yv, w0)


# ----------------------------------------------------------------- KM
def build_km(scale: int = 1):
    """K-means: 3 Lloyd iterations (distances, argmin, centroid update)."""
    r = _rng(4)
    N, D, K, ITERS = 24 * scale, 4, 4, 3
    pts = _f32(r.normal(size=(N, D)))
    cent0 = _f32(r.normal(size=(K, D)))

    def km(pts, cent0):
        def lloyd(cent, _):
            diff = pts[:, None, :] - cent[None, :, :]    # (N,K,D) sub
            d2 = torch.sum(diff * diff, -1)              # mul + add chains
            assign = torch.argmin(d2, -1)                # (N,)
            onehot = astype(assign[:, None]
                            == torch.arange(K, dtype=I32)[None, :], F32)
            counts = torch.sum(onehot, 0)                # (K,)
            sums = torch.mm(onehot.t(), pts)             # (K,D)
            new = sums / torch.maximum(counts, imm(1.0, F32))[:, None]
            return new, torch.sum(d2 * onehot)
        return scan(lloyd, cent0, None, length=ITERS)

    return km, (pts, cent0)
