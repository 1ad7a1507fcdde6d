"""Graph-processing benchmarks (Table IV): BFS, DFS, BC, SSSP, CCOMP, PRANK.

Twin of ``repro/workloads/graph.py``: the same deterministic Erdos-Renyi
instances; dense adjacency for the level-synchronous algorithms (bitwise
and/or -- the CiM-native form) and adjacency lists for DFS."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.trace import scan, while_loop
from repro_torch.workloads.lowering import (F32, I32, astype, imm, set_at,
                                            set_static, take, update_at,
                                            where)

INF = 10 ** 6


def _graph(n: int, p: float, seed: int, weighted: bool = False):
    r = np.random.default_rng(seed)
    adj = (r.random((n, n)) < p).astype(np.int32)
    np.fill_diagonal(adj, 0)
    adj = np.maximum(adj, adj.T)                       # undirected
    if weighted:
        w = r.integers(1, 16, (n, n)).astype(np.int32)
        w = np.where(adj > 0, w, INF)
        np.fill_diagonal(w, 0)
        return adj, w
    return adj


# ----------------------------------------------------------------- BFS
def build_bfs(scale: int = 1):
    """Level-synchronous BFS over a boolean frontier: next = (adj AND
    frontier) OR-reduced, masked by ~visited -- pure bitwise CiM ops."""
    n = 20 * scale
    adj = torch.from_numpy(_graph(n, 0.15, 7))

    def bfs(adj):
        frontier0 = set_static(torch.zeros((n,), dtype=I32), 0, 1)
        visited0 = frontier0.clone()               # one buffer, two carries
        depth0 = set_static(torch.full((n,), -1, dtype=I32), 0, 0)

        def step(state, d):
            frontier, visited, depth = state
            reach = torch.sum(adj & frontier[:, None], 0)  # and + or-like add
            nxt = astype(reach > 0, I32) & (imm(1) - visited)
            visited = visited | nxt
            depth = where((nxt > 0) & (depth < 0), d + 1, depth)
            return (nxt, visited, depth), None

        (f, v, depth), _ = scan(step, (frontier0, visited0, depth0),
                                torch.arange(8, dtype=I32))
        return depth, torch.sum(v)

    return bfs, (adj,)


# ----------------------------------------------------------------- DFS
def build_dfs(scale: int = 1):
    """Iterative DFS with an explicit stack (pointer chasing: dynamic
    slices and stack updates -- the paper's least CiM-favorable pattern)."""
    n = 12 * scale
    adj = np.asarray(_graph(n, 0.2, 8))
    deg = adj.sum(1)
    max_deg = int(deg.max())
    nbrs = np.full((n, max_deg), -1, np.int32)
    for u in range(n):
        vs = np.nonzero(adj[u])[0]
        nbrs[u, :len(vs)] = vs
    nbrs = torch.from_numpy(nbrs)

    def dfs(nbrs):
        stack0 = set_static(torch.full((4 * n,), -1, dtype=I32), 0, 0)
        state0 = (stack0, imm(1), torch.zeros((n,), dtype=I32), imm(0))

        def cond(s):
            return s[1] > 0

        def body(s):
            stack, top, visited, order = s
            u = take(stack, top - 1)
            top = top - 1
            seen = take(visited, u) > 0
            visited = set_at(visited, u, imm(1))
            order = order + astype(where(seen, 0, 1), I32)

            def push(carry, v):
                stack, top = carry
                ok = (v >= 0) & (take(visited, v) == 0) & ~seen
                stack = update_at(stack, where(ok, v, take(stack, top))
                                  .reshape(1), top)
                return (stack, top + astype(ok, I32)), None
            (stack, top), _ = scan(push, (stack, top), take(nbrs, u))
            return stack, top, visited, order

        stack, top, visited, order = while_loop(cond, body, state0)
        return order, visited

    return dfs, (nbrs,)


# ----------------------------------------------------------------- BC
def build_bc(scale: int = 1):
    """Betweenness centrality (Brandes, single source): BFS counting
    shortest paths, then reverse dependency accumulation (float div/mul)."""
    n = 10 * scale
    adj = torch.from_numpy(_graph(n, 0.25, 9))
    MAXD = 6

    def bc(adj):
        adjf = adj.to(F32)
        dist0 = set_static(torch.full((n,), -1, dtype=I32), 0, 0)
        sigma0 = set_static(torch.zeros((n,), dtype=F32), 0, 1.0)

        def fwd(state, d):
            dist, sigma = state
            frontier = astype(dist == d, F32)
            contrib = torch.mv(adjf.t(), sigma * frontier)   # path counts
            new = (dist < 0) & (contrib > 0)
            dist = where(new, d + 1, dist)
            sigma = sigma + where(new, contrib, 0.0)
            return (dist, sigma), None
        (dist, sigma), _ = scan(fwd, (dist0, sigma0),
                                torch.arange(MAXD, dtype=I32))

        delta0 = torch.zeros((n,), dtype=F32)

        def bwd(delta, d_rev):
            d = imm(MAXD - 1) - d_rev
            on_level = astype(dist == (d + 1), F32)
            coeff = where(sigma > 0, (imm(1.0, F32) + delta)
                          / torch.maximum(sigma, imm(1e-9, F32)), 0.0)
            pred_mask = astype(dist == d, F32)
            acc = torch.mv(adjf, coeff * on_level)
            delta = delta + pred_mask * sigma * acc
            return delta, None
        delta, _ = scan(bwd, delta0, torch.arange(MAXD, dtype=I32))
        return delta

    return bc, (adj,)


# ----------------------------------------------------------------- SSSP
def build_sssp(scale: int = 1):
    """Bellman-Ford via min-plus relaxation (integer add + min: the
    CiM-supported op pair)."""
    n = 14 * scale
    _, w = _graph(n, 0.25, 10, weighted=True)
    w = torch.from_numpy(w)

    def sssp(w):
        dist0 = set_static(torch.full((n,), INF, dtype=I32), 0, 0)

        def relax(dist, _):
            cand = torch.amin(dist[:, None] + w, 0)      # add + min chains
            return torch.minimum(dist, cand), None
        dist, _ = scan(relax, dist0, None, length=6)
        return dist

    return sssp, (w,)


# ----------------------------------------------------------------- CCOMP
def build_ccomp(scale: int = 1):
    """Connected components by label propagation (integer min over
    neighbors)."""
    n = 20 * scale
    adj = torch.from_numpy(_graph(n, 0.08, 11))

    def ccomp(adj):
        labels0 = torch.arange(n, dtype=I32)
        big = imm(INF)

        def prop(labels, _):
            nbr = torch.where(adj > 0, labels[None, :], big)
            best = torch.amin(nbr, 1)
            return torch.minimum(labels, best), None
        labels, _ = scan(prop, labels0, None, length=6)
        return labels

    return ccomp, (adj,)


# ----------------------------------------------------------------- PRANK
def build_prank(scale: int = 1):
    """PageRank power iteration (float mul/add matvec + damping)."""
    n = 14 * scale
    adj_np = _graph(n, 0.2, 12)
    deg = np.maximum(adj_np.sum(1), 1)
    P = torch.from_numpy((adj_np / deg[:, None]).astype(np.float32))

    def prank(P):
        r0 = torch.full((n,), 1.0 / n, dtype=F32)

        def it(rv, _):
            rv2 = imm(0.85, F32) * torch.mv(P.t(), rv) + 0.15 / n
            return rv2, torch.sum(torch.abs(rv2 - rv))
        return scan(it, r0, None, length=5)

    return prank, (P,)
