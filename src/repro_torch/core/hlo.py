"""ATen-graph analysis: Eva-CiM's IDG offload analysis adapted to a model
step (twin of ``repro/core/hlo.py``'s fusion half).

The reference walks a jaxpr; the port records the step's ATen graph and
walks that.  :class:`GraphRecorder` is a ``TorchDispatchMode`` that runs
the step eagerly and writes down one :class:`Eqn` per ATen op: its op
class, the values it reads and the values it writes.  A value is a tensor
as one op wrote it (an in-place op writes a new value); the recorder keeps
each value's shape and dtype, never the tensor, so a recorded step holds
no activation alive.  Tensors are keyed through a weak identity map, so a
freed tensor's ``id`` cannot alias a live one.  The backward runs on
autograd's threads, which inherit the mode, so its ops are recorded too.

:func:`fusion_candidates` is the reference's walk line for line: an
"offloading candidate" is a chain of elementwise ops (ending, at most, in
one reduction) whose intermediate tensors can stay in on-chip memory — one
HBM round trip instead of many.  The accelerator-mode MACR is the fraction
of the step's HBM traffic such fusion removes.

The op classes are the reference's sets of jaxpr primitives;
:data:`ATEN_TWINS` lists beside each primitive the ATen ops that take its
place in the recorded graph.  An in-place ATen op (``add_``) takes its
out-of-place op's place; an op in no list is "other", as an unknown
primitive is in the reference.  Collective parsing of HLO text
(``collective_bytes``, ``scan_trip_counts``, ``shape_bytes``) belongs to the
sharded dry run and has no twin here yet.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

# op classes for the dataflow walk: the reference's sets, verbatim
_ELEMENTWISE = {
    "add", "sub", "mul", "div", "max", "min", "and", "or", "xor", "not",
    "neg", "abs", "exp", "log", "tanh", "logistic", "sqrt", "rsqrt",
    "select_n", "clamp", "lt", "le", "gt", "ge", "eq", "ne", "sign",
    "floor", "ceil", "round", "convert_element_type", "integer_pow",
    "erf", "sin", "cos", "pow", "square", "cbrt", "is_finite", "rem",
}
_REDUCTION = {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
              "argmax", "argmin", "reduce_and", "reduce_or", "cumsum",
              "cummax", "cummin", "cumlogsumexp"}
_MATMUL = {"dot_general", "conv_general_dilated"}
_VIEW = {"reshape", "squeeze", "expand_dims", "broadcast_in_dim",
         "transpose", "slice", "rev", "stop_gradient", "copy", "bitcast",
         "convert_element_type"}

#: each jaxpr primitive of the sets above, beside the ATen ops (overload
#: packets of the ``aten`` namespace) that take its place in a recorded
#: graph.  ``sigmoid_backward`` and ``tanh_backward`` are the products
#: that ``jax.grad`` writes as ``mul`` eqns; ``mean`` is the reference's
#: ``reduce_sum`` (then a ``div``); ``_to_copy`` is a dtype conversion.
ATEN_TWINS: Dict[str, Tuple[str, ...]] = {
    # elementwise
    "add": ("add",), "sub": ("sub", "rsub"),
    "mul": ("mul", "sigmoid_backward", "tanh_backward"),
    "div": ("div", "reciprocal"),
    "max": ("maximum", "clamp_min"), "min": ("minimum", "clamp_max"),
    "and": ("bitwise_and", "logical_and"), "or": ("bitwise_or", "logical_or"),
    "xor": ("bitwise_xor", "logical_xor"),
    "not": ("bitwise_not", "logical_not"),
    "neg": ("neg",), "abs": ("abs",), "exp": ("exp",), "log": ("log",),
    "tanh": ("tanh",), "logistic": ("sigmoid",), "sqrt": ("sqrt",),
    "rsqrt": ("rsqrt",), "select_n": ("where", "masked_fill"),
    "clamp": ("clamp",), "lt": ("lt",), "le": ("le",), "gt": ("gt",),
    "ge": ("ge",), "eq": ("eq",), "ne": ("ne",), "sign": ("sign", "sgn"),
    "floor": ("floor",), "ceil": ("ceil",), "round": ("round",),
    "pow": ("pow",), "erf": ("erf",), "sin": ("sin",), "cos": ("cos",),
    "square": ("square",), "is_finite": ("isfinite",),
    "rem": ("remainder", "fmod"),
    # reductions
    "reduce_sum": ("sum", "mean"), "reduce_max": ("amax", "max"),
    "reduce_min": ("amin", "min"), "reduce_prod": ("prod",),
    "argmax": ("argmax",), "argmin": ("argmin",), "reduce_and": ("all",),
    "reduce_or": ("any",), "cumsum": ("cumsum",), "cummax": ("cummax",),
    "cummin": ("cummin",), "cumlogsumexp": ("logcumsumexp",),
    # matmuls
    "dot_general": ("mm", "bmm", "addmm", "baddbmm"),
    "conv_general_dilated": ("convolution",),
    # views
    "reshape": ("view", "_unsafe_view", "reshape", "_reshape_alias",
                "as_strided"),
    "squeeze": ("squeeze",), "expand_dims": ("unsqueeze",),
    "broadcast_in_dim": ("expand",),
    "transpose": ("permute", "transpose", "t"),
    "slice": ("slice", "select", "narrow", "split", "split_with_sizes",
              "unbind"),
    "rev": ("flip",), "stop_gradient": ("detach",),
    "copy": ("clone", "alias", "lift_fresh", "lift_fresh_copy", "copy"),
    "convert_element_type": ("_to_copy",),
}

_PRIM_OF: Dict[str, str] = {aten: prim for prim, atens in ATEN_TWINS.items()
                            for aten in atens}


def klass_of(prim: str) -> str:
    """The reference's ``klass`` of a primitive name (checked in its
    order: a name in two sets takes the first)."""
    if prim in _MATMUL:
        return "matmul"
    if prim in _REDUCTION:
        return "reduction"
    if prim in _VIEW:
        return "view"
    if prim in _ELEMENTWISE:
        return "elementwise"
    return "other"


def primitive_of(func) -> str:
    """The reference's primitive name for an ATen op, or the op's own
    qualified name (``aten.cat``) for an op without one (class
    "other")."""
    qualified = str(func.overloadpacket)
    name = func.overloadpacket.__name__
    if qualified == f"aten.{name}":
        if name in _PRIM_OF:
            return _PRIM_OF[name]
        if name.endswith("_") and not name.startswith("_") \
                and name[:-1] in _PRIM_OF:
            return _PRIM_OF[name[:-1]]             # in place: a new value
    return qualified


@dataclasses.dataclass(frozen=True)
class Eqn:
    """One recorded ATen op: the jaxpr equation's analogue."""
    prim: str                          # reference primitive or aten.<name>
    aten: str                          # the overload, aten.mm.default
    invars: Tuple[int, ...]            # values read (tensor arguments)
    outvars: Tuple[int, ...]           # values written

    @property
    def klass(self) -> str:
        return klass_of(self.prim)


@dataclasses.dataclass
class Graph:
    """A recorded step: its equations in execution order, and each value's
    shape and element size (a value's id indexes both lists)."""
    eqns: List[Eqn]
    shapes: List[Tuple[int, ...]]
    itemsizes: List[int]

    def nbytes(self, v: int) -> int:
        n = 1
        for d in self.shapes[v]:
            n *= d
        return n * self.itemsizes[v]


class GraphRecorder(TorchDispatchMode):
    """Record every ATen op run under the mode as an :class:`Eqn`.

    A tensor the graph has not seen (a parameter, an input, a tensor
    autograd unpacks for the backward) becomes a value without a producer,
    as a jaxpr's inputs are.  Arguments an op writes in place, and every
    tensor it returns, become new values.  Ops that touch no tensor (dtype
    promotion queries) are not recorded."""

    def __init__(self):
        super().__init__()
        self.eqns: List[Eqn] = []
        self.shapes: List[Tuple[int, ...]] = []
        self.itemsizes: List[int] = []
        self._ids = WeakIdKeyDictionary()
        self._ops: Dict[Any, Tuple[str, Tuple[Tuple[int, str], ...]]] = {}
        self._lock = threading.Lock()

    def _new_value(self, t: torch.Tensor) -> int:
        vid = len(self.shapes)
        self.shapes.append(tuple(t.shape))
        self.itemsizes.append(t.element_size())
        self._ids[t] = vid
        return vid

    def _read(self, t: torch.Tensor) -> int:
        vid = self._ids.get(t)
        return self._new_value(t) if vid is None else vid

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self._ops.get(func)
        if info is None:
            info = self._ops[func] = _op_info(func)
        prim, writes = info
        with self._lock:
            ins = tuple(self._read(t) for t in tree_leaves((args, kwargs))
                        if isinstance(t, torch.Tensor))
            returned = [t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
            written = [t for t in _written(writes, args, kwargs)
                       if not any(t is r for r in returned)]
            outs = tuple(self._new_value(t) for t in returned + written)
            if ins or outs:
                self.eqns.append(Eqn(prim, str(func), ins, outs))
        return out

    def graph(self) -> Graph:
        with self._lock:
            return Graph(list(self.eqns), list(self.shapes),
                         list(self.itemsizes))


def _op_info(func) -> Tuple[str, Tuple[Tuple[int, str], ...]]:
    """``func``'s primitive name and the (position, name) of each argument
    its schema marks as written."""
    writes = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write)
    return primitive_of(func), writes


def _written(writes, args, kwargs) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for i, name in writes:
        val = args[i] if i < len(args) else kwargs.get(name)
        out.extend(t for t in tree_leaves(val)
                   if isinstance(t, torch.Tensor))
    return out


def record_graph(fn: Callable, *args, **kwargs) -> Tuple[Graph, Any]:
    """Run ``fn(*args, **kwargs)`` eagerly under a :class:`GraphRecorder`:
    the port's ``jax.make_jaxpr``.  Returns the graph and ``fn``'s
    result."""
    rec = GraphRecorder()
    with rec:
        out = fn(*args, **kwargs)
    return rec.graph(), out


# ======================================================================
# fusion-candidate analysis (the accelerator-mode IDG)
# ======================================================================
@dataclasses.dataclass
class FusionCandidate:
    """A chain of elementwise/reduction eqns whose intermediates stay in
    on-chip memory when fused — the analogue of one CiM offloading
    candidate."""
    eqn_ids: List[int]
    ops: List[str]
    input_bytes: int                   # HBM reads the fused kernel still does
    output_bytes: int                  # HBM writes it still does
    saved_bytes: int                   # intermediate HBM round-trips removed

    @property
    def n_ops(self) -> int:
        return len(self.eqn_ids)


@dataclasses.dataclass
class FusionReport:
    candidates: List[FusionCandidate]
    total_bytes: int                   # all tensor traffic if nothing fuses
    saved_bytes: int

    @property
    def tpu_macr(self) -> float:
        """Fraction of HBM traffic eliminable by on-chip fusion — the
        accelerator-mode MACR."""
        return self.saved_bytes / self.total_bytes if self.total_bytes else 0.0


def fusion_candidates(graph: Graph, min_bytes: int = 1 << 12) -> FusionReport:
    """Walk a recorded graph's dataflow and greedily group connected
    elementwise (+ terminal reduction) eqns, as Algorithm 1 walks the IDG:
    chains rooted at a fusable op, leaves = HBM-resident tensors.

    ``min_bytes``: tensors smaller than this are considered register/SMEM
    resident (scalars, small params) and are not counted as traffic.
    """
    eqns = graph.eqns
    nbytes = graph.nbytes
    # def/use maps over values
    producer: Dict[int, int] = {}
    consumers: Dict[int, List[int]] = {}
    for i, eqn in enumerate(eqns):
        for v in eqn.outvars:
            producer[v] = i
        for v in eqn.invars:
            consumers.setdefault(v, []).append(i)

    klass = [e.klass for e in eqns]

    total_bytes = 0
    for i, eqn in enumerate(eqns):
        if klass[i] == "view":
            continue
        for v in eqn.invars + eqn.outvars:
            b = nbytes(v)
            total_bytes += b if b >= min_bytes else 0

    claimed: Set[int] = set()
    cands: List[FusionCandidate] = []
    # reverse walk: consumers first => maximal chains (same as offload.py)
    for i in range(len(eqns) - 1, -1, -1):
        if i in claimed or klass[i] not in ("elementwise", "reduction"):
            continue
        group = []
        stack = [i]
        while stack:
            j = stack.pop()
            if j in claimed:
                continue
            if klass[j] not in ("elementwise", "reduction", "view"):
                continue
            claimed.add(j)
            group.append(j)
            for v in eqns[j].invars:
                p = producer.get(v)
                if p is None or p in claimed:
                    continue
                # only fuse through single-consumer intermediates
                if len(consumers.get(v, ())) == 1 and \
                        klass[p] in ("elementwise", "view"):
                    stack.append(p)
        real = [j for j in group if klass[j] != "view"]
        if len(real) < 2:
            for j in group:
                claimed.discard(j)
            continue
        gset = set(group)
        in_b = out_b = saved = 0
        for j in group:
            for v in eqns[j].invars:
                b = nbytes(v)
                if b < min_bytes:
                    continue
                p = producer.get(v)
                if p in gset:
                    saved += 2 * b              # intermediate: store+load gone
                else:
                    in_b += b
            for v in eqns[j].outvars:
                b = nbytes(v)
                if b < min_bytes:
                    continue
                outside = [c for c in consumers.get(v, ()) if c not in gset]
                if outside or producer.get(v) == group[-1]:
                    out_b += b
        cands.append(FusionCandidate(sorted(group),
                                     [eqns[j].prim for j in sorted(group)],
                                     in_b, out_b, saved))
    saved_total = sum(c.saved_bytes for c in cands)
    return FusionReport(cands, total_bytes, saved_total)
