"""The paper's 17 benchmark applications (Table IV) as torch programs.

Twin of ``repro.workloads``.  Every workload module exposes
``build_<name>(scale=1) -> (fn, args)``: the reference's inputs, drawn from
the same ``np.random.default_rng`` seeds and cast to its dtypes, and a
program written op for op like the reference's, in plain batched torch ops
(jnp's lowerings spelled out by :mod:`repro_torch.workloads.lowering`,
loops by :func:`repro_torch.core.trace.scan` / ``while_loop``).
``fn(*args)`` runs eagerly; the trace VM
(:func:`repro_torch.core.trace.trace_structural`) runs the same call and
commits the reference VM's instruction columns.  Sizes put a full trace in
the 10^3-10^5 instruction range.  Documented kernel reductions: M2D ->
IDCT + motion compensation; h264ref -> SAD motion search; mcf ->
Bellman-Ford edge relaxation on the min-cost network; hmmer -> Viterbi
recursion.

:mod:`repro_torch.workloads.fixtures` holds the reference's committed
traces of these programs: the oracle the VM is held against.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.workloads import graph, media, ml, spec, strings

WORKLOADS: Dict[str, Callable] = {
    # machine learning
    "NB": ml.build_nb,
    "DT": ml.build_dt,
    "SVM": ml.build_svm,
    "LiR": ml.build_lir,
    "KM": ml.build_km,
    # string processing
    "LCS": strings.build_lcs,
    # multimedia
    "M2D": media.build_m2d,
    # graph processing
    "BFS": graph.build_bfs,
    "DFS": graph.build_dfs,
    "BC": graph.build_bc,
    "SSSP": graph.build_sssp,
    "CCOMP": graph.build_ccomp,
    "PRANK": graph.build_prank,
    # SPEC 2006 kernels
    "astar": spec.build_astar,
    "h264ref": spec.build_h264ref,
    "hmmer": spec.build_hmmer,
    "mcf": spec.build_mcf,
}

CATEGORY = {
    "NB": "ml", "DT": "ml", "SVM": "ml", "LiR": "ml", "KM": "ml",
    "LCS": "string", "M2D": "media",
    "BFS": "graph", "DFS": "graph", "BC": "graph", "SSSP": "graph",
    "CCOMP": "graph", "PRANK": "graph",
    "astar": "spec", "h264ref": "spec", "hmmer": "spec", "mcf": "spec",
}


def build(name: str, scale: int = 1):
    """``(fn, args)`` of workload ``name``: ``fn(*args)`` runs it eagerly."""
    return WORKLOADS[name](scale)
