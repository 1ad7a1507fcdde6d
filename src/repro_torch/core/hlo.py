"""ATen-graph analysis: Eva-CiM's IDG offload analysis adapted to a model
step, and the parsing of post-SPMD HLO text (twin of ``repro/core/hlo.py``).

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
primitive is in the reference.

A step that runs on DTensors is recorded *per device*: the recorder steps
aside for every op on a DTensor (returning ``NotImplemented``, so DTensor
unwraps it), skips DTensor's own sharding propagation (which runs the op
on fake tensors of the global shape) and records the local ops and the
collectives that DTensor issues, as a post-SPMD HLO module holds one
device's program.  :data:`COLLECTIVES` names
each collective op by its HLO opcode.

Collective parsing of HLO text (``shape_bytes``, ``collective_bytes``,
``scan_trip_counts``) is the reference's, as string functions: the port has
no HLO, so they serve text from elsewhere and the tests that hold them.
"""
from __future__ import annotations

import array
import dataclasses
import re
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ======================================================================
# 1. collective parsing (post-SPMD HLO text)
# ======================================================================
_COLL_RE = re.compile(
    r"(\w[\w.\-]*)\s*=\s*((?:\([^)]*\))|(?:\S+))\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)\b")
_SHAPE_RE = re.compile(
    r"(f64|f32|bf16|f16|f8\w*|s64|s32|s16|s8|u64|u32|u16|u8|pred)\[([\d,]*)\]")

_DTYPE_BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
                "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
                "s8": 1, "u8": 1, "pred": 1}


def shape_bytes(type_str: str) -> int:
    """Total bytes of every typed shape in an HLO type string."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        b = _DTYPE_BYTES.get(dt, 1 if dt.startswith("f8") else 4)
        total += n * b
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-device bytes by collective kind, from result shapes."""
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        kind = m.group(3)
        nbytes = shape_bytes(m.group(2))
        out[kind] = out.get(kind, 0) + nbytes
        out[kind + "_count"] = out.get(kind + "_count", 0) + 1
    out["total"] = sum(v for k, v in out.items() if not k.endswith("_count"))
    return out


def scan_trip_counts(hlo_text: str) -> List[int]:
    return [int(x) for x in re.findall(r"trip_count=(\d+)", hlo_text)]


# ======================================================================
# 2. the recorded ATen graph
# ======================================================================
#: each collective op DTensor issues, by its HLO opcode (the keys of
#: :func:`collective_bytes`); ``shard_dim_alltoall`` is DTensor's own
#: all-to-all of one sharded dim
COLLECTIVES: Dict[str, str] = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}

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
    promotion queries) are not recorded.  On DTensors, only one device's
    local ops and collectives are (see the module docstring).

    Each op's tensors are found through a plan made once per overload
    from its schema (:class:`_OpPlan`), in the order
    ``tree_leaves((args, kwargs))`` gives them; an op with a value of a
    type the plan does not know (:func:`_into`) is walked with
    ``tree_leaves``, and :attr:`fallback_eqns` counts the eqns recorded
    that way.  Eqns are stored as integers until :meth:`graph` builds the
    :class:`Graph`."""

    def __init__(self):
        super().__init__()
        self.shapes: List[Tuple[int, ...]] = []
        self.itemsizes: List[int] = []
        #: eqns recorded by walking the arguments and result with pytree
        self.fallback_eqns = 0
        # id(tensor) -> a weak reference to it that carries its value id;
        # the reference's callback drops the entry when the tensor dies,
        # so a later tensor at the same address starts a new value
        self._ids: Dict[int, _ValueRef] = {}
        selfref = weakref.ref(self)

        def forget(ref: _ValueRef) -> None:
            rec = selfref()
            if rec is not None and rec._ids.get(ref.key) is ref:
                del rec._ids[ref.key]
        self._forget = forget
        self._plans: Dict[int, _OpPlan] = {}     # by id(func)
        self._prims: List[str] = []               # by the plan's ``op``
        self._atens: List[str] = []
        # eqn i: op _eqn_ops[i], invars _vars[_ends[i-1]:_splits[i]],
        # outvars _vars[_splits[i]:_ends[i]]
        self._eqn_ops = array.array("q")
        self._splits = array.array("q")
        self._ends = array.array("q")
        self._vars = array.array("q")
        self._lock = threading.Lock()

    def _new_value(self, t: torch.Tensor) -> int:
        vid = len(self.shapes)
        self.shapes.append(tuple(t.shape))
        self.itemsizes.append(t.element_size())
        key = id(t)
        ref = self._ids.get(key)
        if ref is None or ref() is not t:
            ref = self._ids[key] = _ValueRef(t, self._forget)
            ref.key = key
        ref.vid = vid
        return vid

    def _plan(self, func) -> _OpPlan:
        with self._lock:
            plan = self._plans.get(id(func))
            if plan is None or plan.func is not func:
                self._prims.append(primitive_of(func))
                self._atens.append(str(func))
                plan = self._plans[id(func)] = _OpPlan(
                    func, len(self._atens) - 1)
            return plan

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in types:
            if t is not torch.Tensor:                  # a tensor subclass
                if any(issubclass(t, _dtensor_type()) for t in types):
                    return NotImplemented      # DTensor runs it locally
                if any(issubclass(t, _fake_type()) for t in types):
                    return func(*args, **kwargs)   # global-shape propagation
                break
        out = func(*args, **kwargs)
        plan = self._plans.get(id(func))   # OpOverload hashes in Python
        if plan is None or plan.func is not func:
            plan = self._plan(func)
        returned = written = None
        ins = plan.inputs(args, kwargs)
        if ins is not None:
            returned = _tensors_in(out)
        if returned is not None:
            written = _written(plan.writes, args, kwargs, _tensors_in)
        general = written is None
        if general:                                # the walk with pytree
            ins = _leaves((args, kwargs))
            returned = _leaves(out)
            written = _written(plan.writes, args, kwargs, _leaves)
        if written:
            written = [t for t in written
                       if not any(t is r for r in returned)]
        if not (ins or returned or written):
            return out
        with self._lock:
            var, ids = self._vars, self._ids
            for t in ins:
                ref = ids.get(id(t))
                var.append(ref.vid if ref is not None and ref() is t
                           else self._new_value(t))
            self._splits.append(len(var))
            for t in returned:
                var.append(self._new_value(t))
            for t in written:
                var.append(self._new_value(t))
            self._ends.append(len(var))
            self._eqn_ops.append(plan.op)
            self.fallback_eqns += general
        return out

    def graph(self) -> Graph:
        with self._lock:
            prims, atens = list(self._prims), list(self._atens)
            ops, splits, ends = (self._eqn_ops.tolist(),
                                 self._splits.tolist(), self._ends.tolist())
            var = self._vars.tolist()
            shapes, itemsizes = list(self.shapes), list(self.itemsizes)
        starts = [0] + ends[:-1]
        invars = map(tuple, map(var.__getitem__, map(slice, starts, splits)))
        outvars = map(tuple, map(var.__getitem__, map(slice, splits, ends)))
        eqns = list(map(Eqn, map(prims.__getitem__, ops),
                        map(atens.__getitem__, ops), invars, outvars))
        return Graph(eqns, shapes, itemsizes)


class _ValueRef(weakref.ref):
    """A weak reference to a recorded tensor, filed under ``key`` (the
    tensor's ``id``), with the id of the value the tensor holds now."""
    __slots__ = ("key", "vid")


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _fake_type():
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


#: schema types whose values hold no tensor (``ScalarType``, ``Layout`` and
#: ``MemoryFormat`` are ``int`` in a schema)
_PLAIN_TYPES = (torch._C.IntType, torch._C.FloatType, torch._C.BoolType,
                torch._C.NumberType, torch._C.ComplexType,
                torch._C.StringType, torch._C.DeviceObjType,
                torch._C.SymIntType, torch._C.SymBoolType,
                torch._C.NoneType, torch._C.StreamObjType,
                torch._C._GeneratorType)
#: types of a value that holds no tensor (pytree leaves; a number passed
#: for a ``Tensor`` argument reaches the mode as a Python scalar)
_PLAIN_VALUES = frozenset({
    type(None), bool, int, float, complex, str, torch.dtype, torch.device,
    torch.layout, torch.memory_format, torch.SymInt, torch.SymFloat,
    torch.SymBool})


def _plain(tp) -> bool:
    """Whether a value of schema type ``tp`` can hold no tensor: a plain
    type, or an optional or a list of one."""
    while isinstance(tp, (torch._C.OptionalType, torch._C.ListType)):
        tp = tp.getElementType()
    return isinstance(tp, _PLAIN_TYPES)


class _OpPlan:
    """Where one ATen overload's arguments can hold tensors, from its
    schema.  ``slots``: the positions of the positional arguments of
    another type than :func:`_plain` ones (``Tensor``, ``Tensor?[]``,
    ``Any``), in order; ``plain``: the names of the plain ones;
    ``writes``: the (position, name) of each argument the op writes;
    ``op`` indexes the recorder's tables of ``prim`` and ``aten``."""
    __slots__ = ("func", "op", "slots", "plain", "writes")

    def __init__(self, func, op: int):
        args = func._schema.arguments
        self.func, self.op = func, op
        self.plain = frozenset(a.name for a in args if _plain(a.type))
        self.slots = tuple(i for i, a in enumerate(args)
                           if not a.kwarg_only and a.name not in self.plain)
        self.writes = tuple((i, a.name) for i, a in enumerate(args)
                            if a.alias_info is not None
                            and a.alias_info.is_write)

    def inputs(self, args, kwargs) -> Optional[List[torch.Tensor]]:
        """The tensors of ``(args, kwargs)`` in pytree order, or None where
        a value is not one :func:`_into` knows."""
        ts: List[torch.Tensor] = []
        n = len(args)
        for i in self.slots:
            if i >= n:
                break
            v = args[i]
            if isinstance(v, torch.Tensor):
                ts.append(v)
            elif not _into(v, ts):
                return None
        for name, v in kwargs.items():
            if name not in self.plain and not _into(v, ts):
                return None
        return ts


def _into(v, ts: List[torch.Tensor]) -> bool:
    """Append the tensors of ``v`` to ``ts`` in pytree order, where ``v`` is
    a tensor, a plain value, or a tuple or list of such values and lists;
    False, with ``ts`` partly extended, for anything else."""
    if isinstance(v, torch.Tensor):
        ts.append(v)
    elif type(v) is list or type(v) is tuple:
        for x in v:
            if not _into(x, ts):
                return False
    elif type(v) not in _PLAIN_VALUES:
        return False
    return True


def _tensors_in(v) -> Optional[List[torch.Tensor]]:
    """The tensors of a result or a written argument (see :func:`_into`),
    or None."""
    if isinstance(v, torch.Tensor):
        return [v]
    ts: List[torch.Tensor] = []
    return ts if _into(v, ts) else None


def _leaves(v) -> List[torch.Tensor]:
    """The tensors ``tree_leaves`` finds in ``v``: the general path."""
    return [t for t in tree_leaves(v) if isinstance(t, torch.Tensor)]


def _written(writes, args, kwargs, tensors_of):
    """The tensors of the arguments at ``writes`` (see :class:`_OpPlan`),
    each found by ``tensors_of``; None if it returns None for one."""
    out: List[torch.Tensor] = []
    for i, name in writes:
        ts = tensors_of(args[i] if i < len(args) else kwargs.get(name))
        if ts is None:
            return None
        out.extend(ts)
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
# 3. fusion-candidate analysis (the accelerator-mode IDG)
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
