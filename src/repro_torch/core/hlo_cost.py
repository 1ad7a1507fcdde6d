"""Static cost of a recorded ATen graph (the port's counterpart of
``repro/core/hlo_cost.py``'s ``analyze_hlo`` in the accelerator-mode
backend).

The reference parses post-SPMD HLO text and multiplies loop bodies by
their trip counts.  The port's graph is recorded eagerly, so Python loops
are already unrolled and every op appears as often as it ran:

  * ``flops`` — 2·M·N·K for every matrix product of the graph (``mm``,
    ``addmm``: M×K by K×N; ``bmm``, ``baddbmm``: a batch of them; the
    bias of ``addmm``/``baddbmm`` is not counted).  No arch of the
    registry has a convolution, so none is counted;
  * ``bytes`` — the tensor bytes every non-view op reads and writes (the
    reference's ``hlo_bytes``, reported only);
  * ``collectives`` — empty: a graph of one device moves nothing between
    devices.  The sharded dry run's collective parsing waits for its port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.hlo import Graph

_MM = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


@dataclasses.dataclass
class HloCost:
    flops: float
    bytes: float
    collectives: Dict[str, float]

    @property
    def collective_total(self) -> float:
        return sum(v for k, v in self.collectives.items()
                   if not k.endswith("_count"))


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def eqn_flops(graph: Graph, eqn) -> float:
    """FLOPs of one recorded op (0 for anything but a matrix product)."""
    if eqn.aten.rsplit(".", 1)[0] not in _MM:
        return 0.0
    # the two matrix operands are the last two tensor arguments
    a, b = (graph.shapes[v] for v in eqn.invars[-2:])
    return 2.0 * _prod(a) * b[-1]


def analyze_graph(graph: Graph) -> HloCost:
    """FLOPs and byte footprint of a recorded graph."""
    flops = 0.0
    nbytes = 0
    for eqn in graph.eqns:
        flops += eqn_flops(graph, eqn)
        if eqn.klass != "view":
            nbytes += sum(graph.nbytes(v) for v in eqn.invars + eqn.outvars)
    return HloCost(flops=flops, bytes=float(nbytes), collectives={})
