"""SPEC 2006 kernels (Table IV): astar, h264ref, hmmer, mcf -- each reduced
to its documented hot loop.

Twin of ``repro/workloads/spec.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.trace import scan
from repro_torch.workloads.lowering import (I32, astype, clip, floor_divide,
                                            imm, remainder, set_at,
                                            set_static, take, take2, where,
                                            wrap)

INF = 10 ** 6


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


# ---------------------------------------------------------------- astar
def build_astar(scale: int = 1):
    """Grid A*: open-set relaxation with f = g + h (Manhattan heuristic).
    argmin open-node select + neighbor relax per step."""
    r = np.random.default_rng(13)
    n = 8 * scale
    cost = _i32(r.integers(1, 8, (n, n)))
    STEPS = 3 * n

    def astar(cost):
        N = n * n
        gx = floor_divide(torch.arange(N, dtype=I32), n)
        gy = remainder(torch.arange(N, dtype=I32), n)
        h = (imm(n - 1) - gx) + (imm(n - 1) - gy)        # Manhattan to corner
        g0 = set_static(torch.full((N,), INF, dtype=I32), 0, 0)
        open0 = set_static(torch.zeros((N,), dtype=I32), 0, 1)
        closed0 = torch.zeros((N,), dtype=I32)

        def step(state, _):
            g, open_, closed = state
            f = where(open_ > 0, g + h, INF)
            u = torch.argmin(f)                          # cheapest open node
            open_ = set_at(open_, u, imm(0))
            closed = set_at(closed, u, imm(1))
            ux, uy = floor_divide(u, n), remainder(u, n)
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                vx, vy = ux + dx, uy + dy
                ok = (vx >= 0) & (vx < n) & (vy >= 0) & (vy < n)
                v = clip(vx * n + vy, 0, N - 1)
                cand = take(g, u) + take2(cost, clip(vx, 0, n - 1),
                                          clip(vy, 0, n - 1))
                better = ok & (cand < take(g, v)) & (take(closed, v) == 0)
                g = set_at(g, v, where(better, cand, take(g, v)))
                open_ = set_at(open_, v, where(better, 1, take(open_, v)))
            return (g, open_, closed), None

        (g, open_, closed), _ = scan(step, (g0, open0, closed0), None,
                                     length=STEPS)
        return g[N - 1], g

    return astar, (cost,)


# -------------------------------------------------------------- h264ref
def build_h264ref(scale: int = 1):
    """Motion-estimation SAD search: sum of absolute differences of the
    current 8x8 block against every candidate in a search window (integer
    sub/abs/add chains -- the encoder's dominant kernel)."""
    r = np.random.default_rng(14)
    B, W = 8, 6 * scale                                 # block, window
    cur = _i32(r.integers(0, 255, (B, B)))
    ref = _i32(r.integers(0, 255, (B + W, B + W)))

    def h264(cur, ref):
        offs = torch.arange(W, dtype=I32)
        dy = wrap(offs, B + W)
        dx = wrap(offs, B + W)
        # every B x B window of ref, indexed by its corner: a view
        windows = ref.unfold(0, B, 1).unfold(1, B, 1)
        win = windows[dy[:, None], dx[None, :]]         # (W, W, B, B)
        sads = torch.sum(torch.abs(win - cur), (2, 3))
        best = torch.argmin(sads.reshape(-1))
        return best, sads

    return h264, (cur, ref)


# ---------------------------------------------------------------- hmmer
def build_hmmer(scale: int = 1):
    """Viterbi recursion of a profile HMM (hmmsearch's P7Viterbi core):
    dp[t,j] = emit[j,obs_t] + max_i(dp[t-1,i] + trans[i,j]) -- integer
    add/max in fixed-point, exactly the CiM-supported pair."""
    r = np.random.default_rng(15)
    M, T, A = 8 * scale, 16, 4                         # states, seq len, alphabet
    obs = _i32(r.integers(0, A, (T,)))
    emit = _i32(r.integers(-32, 0, (M, A)))
    trans = _i32(r.integers(-16, 0, (M, M)))

    def hmmer(obs, emit, trans):
        dp0 = take(emit, obs[0], dim=1)

        def step(dp, o_t):
            cand = dp[:, None] + trans                  # (M, M) adds
            best = torch.amax(cand, 0)                  # max chains
            dp2 = best + take(emit, o_t, dim=1)
            return dp2, torch.amax(dp2)
        dp, path_scores = scan(step, dp0, obs[1:])
        return torch.amax(dp), path_scores

    return hmmer, (obs, emit, trans)


# ------------------------------------------------------------------ mcf
def build_mcf(scale: int = 1):
    """Min-cost-flow price update core (simplified SPFA/Bellman-Ford over
    the residual network's edge list): read endpoints, relax, write back --
    pointer-heavy like the real mcf."""
    r = np.random.default_rng(16)
    n, m = 12 * scale, 36 * scale
    src = _i32(r.integers(0, n, (m,)))
    dst = _i32(r.integers(0, n, (m,)))
    w = _i32(r.integers(1, 10, (m,)))

    def mcf(src, dst, w):
        dist0 = set_static(torch.full((n,), INF, dtype=I32), 0, 0)

        def relax_round(dist, _):
            def relax_edge(d, e):
                s, t, we = e
                cand = take(d, s) + we
                better = cand < take(d, t)
                d = set_at(d, t, where(better, cand, take(d, t)))
                return d, astype(better, I32)
            dist, improved = scan(relax_edge, dist, (src, dst, w))
            return dist, torch.sum(improved)
        return scan(relax_round, dist0, None, length=4)

    return mcf, (src, dst, w)
