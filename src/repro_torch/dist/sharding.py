"""Logical-axis sharding over DTensor: rules mapping model-semantic axis
names to mesh axes (port of ``repro.dist.sharding``).

Model code annotates activations with *logical* names only --
``shard(x, "batch", "seq", "embed")`` -- and stays mesh-agnostic.  A launch
site builds a rule table with :func:`make_rules` (logical name -> mesh axis
or ``None``) and activates it with :func:`use_rules`; outside an active
context ``shard`` is the identity, so single-device tests and the trace VM
never touch DTensor.

A *spec* is the reference's ``PartitionSpec`` as a tuple: one entry per
dim, a mesh-axis name or ``None``, and ``()`` for a replicated leaf, so
``tuple(reference_spec) == port_spec``.  Parameter / optimizer / input
specs are shape-driven, the reference's rules letter for letter:
``param_specs`` partitions each leaf's largest mesh-divisible dimension
across the model axis (ties pick the trailing dim), ``opt_state_specs``
additionally spreads one remaining dimension across the data axis (ZeRO-1),
``batch_input_shardings`` splits the leading batch dimension across the
data axis and ``cache_specs`` the batch dimension (axis 1) of a stacked
decode cache.  Every rule degrades to replication when a dimension does
not divide evenly.

The spec functions read only a mesh's axis names and sizes, so they run on
an :class:`AbstractMesh` (the twin of ``jax.sharding.AbstractMesh``) with
no process group.  :func:`named` turns specs into DTensor placements on a
``DeviceMesh``, :func:`distribute` places a tree of tensors by them, and
:func:`shard` redistributes an activation.

Usage::

    mesh = launch.mesh.make_host_mesh(model_parallel=2)
    rules = sharding.make_rules(cfg, mesh)
    params = sharding.distribute(params, mesh, sharding.named(
        mesh, sharding.param_specs(cfg, mesh, params)))
    with sharding.use_rules(mesh, rules):
        out = model(params, batch)       # shard() calls now redistribute
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.optim.tree import tree_map

# logical activation axes that map onto the model-parallel mesh axis
_MODEL_AXES = ("heads", "kv_heads", "dff", "vocab", "expert", "embed_out")
# logical axes that stay replicated (sequence / feature dims)
_REPLICATED = ("seq", "embed", "cap")

Spec = Tuple[Optional[str], ...]

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices: what the spec functions read
    (``jax.sharding.AbstractMesh``)."""
    shape_tuple: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.shape_tuple


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`
    (the reference's ``dict(mesh.shape)``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _ctx():
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_rules(mesh, rules: Dict[str, Optional[str]]):
    """Activate ``rules`` for all :func:`shard` calls in this thread.

    Tensors the model makes inside (positions, masks, accumulators) are
    the same on every rank; under the rules DTensor takes such plain
    tensors as replicated (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        stack.pop()


def _axis_size(mesh, axis: Optional[str]) -> int:
    if axis is None:
        return 1
    return int(mesh_axes(mesh).get(axis, 1))


def make_rules(cfg, mesh, shape=None, strategy: str = "auto"
               ) -> Dict[str, Optional[str]]:
    """Logical-name -> mesh-axis table for ``cfg`` on ``mesh``.

    ``strategy`` "auto"/"2d" uses (data, model) when both exist; "data"
    forces pure data parallelism (model axes replicated).  Any other name
    ("dp", "sp") acts as "auto", as in the reference."""
    axes = mesh_axes(mesh)
    data = "data" if axes.get("data", 1) > 1 else None
    model = "model" if axes.get("model", 1) > 1 else None
    if strategy == "data":
        model = None
    rules: Dict[str, Optional[str]] = {"batch": data}
    for name in _MODEL_AXES:
        rules[name] = model
    for name in _REPLICATED:
        rules[name] = None
    return rules


def activation_spec(mesh, rules, shape, names) -> Spec:
    """The spec :func:`shard` gives a tensor of ``shape`` annotated with
    ``names``: each mapped mesh axis once, and ``None`` where the axis does
    not divide the dim; ``()`` when nothing is sharded."""
    if len(names) != len(shape):
        raise ValueError(f"shard(): {len(names)} axis names for a "
                         f"{len(shape)}-d array of shape {tuple(shape)}")
    spec, used = [], set()
    for dim, name in zip(shape, names):
        axis = rules.get(name) if name else None
        if axis is None or axis in used or dim % _axis_size(mesh, axis):
            spec.append(None)
        else:
            spec.append(axis)
            used.add(axis)
    return tuple(spec) if any(spec) else ()


def placements(mesh, spec: Spec):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on the mesh
    axis that dim ``d`` names, ``Replicate()`` on every other axis."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard(x, *names: Optional[str]):
    """Constrain ``x``'s sharding by logical axis names: the identity when
    no rules are active or nothing maps to a dividing mesh axis, else a
    redistribution of the DTensor ``x`` to the spec's placements."""
    ctx = _ctx()
    if ctx is None:
        return x
    mesh, rules = ctx
    spec = activation_spec(mesh, rules, tuple(x.shape), names)
    if not spec:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"shard(): a plain tensor of shape {tuple(x.shape)} "
                        f"under active rules (spec {spec}); place the "
                        "step's parameters and inputs on the mesh first")
    return x.redistribute(mesh, placements(mesh, spec))


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:            # the unsharded path: no import
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def with_rules(mesh, rules, fn):
    """``fn`` run under ``use_rules(mesh, rules)`` at every call."""
    def run(*args, **kwargs):
        with use_rules(mesh, rules):
            return fn(*args, **kwargs)
    return run


def reduce_partial(x):
    """A DTensor with every pending (partial) sum done: replicated on the
    mesh axes it was partial on."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh,
                                                               pl)


def rules_mesh(mesh, rules):
    """The sub-mesh of the axes ``rules`` map a name to, in the mesh's
    order (``mesh`` itself when they map to all of its axes or none).

    Placements live on this mesh, so an axis no rule uses replicates the
    whole step, as it does under the reference's rules: on the full mesh
    DTensor would be free to split an op over an axis no rule names (the
    model axis under ``strategy="data"``, the pod axis of the multi-pod
    mesh)."""
    used = set(a for a in rules.values() if a is not None)
    names = tuple(n for n in mesh.mesh_dim_names if n in used)
    if not names or len(names) == len(mesh.mesh_dim_names):
        return mesh
    return mesh[names]


def batch_full(ref, shape, value, dtype, batch_dim: int = 0,
               ref_batch_dim: int = 0):
    """``torch.full(shape, value)`` on ``ref``'s device, for a tensor whose
    dim ``batch_dim`` is the batch dim ``ref_batch_dim`` of ``ref``: a
    DTensor ``ref`` gives a DTensor split on the batch as ``ref`` is (and
    replicated on every other axis), so a state or accumulator the step
    makes for each row is computed on this device's rows only."""
    if not is_dtensor(ref):
        return torch.full(shape, value, dtype=dtype, device=ref.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ref.device_mesh
    local = list(shape)
    pl = []
    for i, p in enumerate(ref.placements):
        if p.is_shard(ref_batch_dim):
            pl.append(Shard(batch_dim))
            local[batch_dim] //= mesh.size(i)
        else:
            pl.append(Replicate())
    t = torch.full(local, value, dtype=dtype, device=ref.to_local().device)
    full = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(t, mesh, tuple(pl), run_check=False,
                              shape=full.shape, stride=full.stride())


def unshard_dim(x, dim: int):
    """``x`` with no mesh axis sharding ``dim`` (a DTensor sharded there is
    gathered on it; anything else is returned as it is)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh,
                                                               pl)


# ---------------------------------------------------------------- specs
def _leaf_spec(shape: Tuple[int, ...], axis: Optional[str], size: int) -> Spec:
    """Partition the largest ``size``-divisible dim of ``shape`` on ``axis``
    (ties pick the trailing dim: output features / vocab)."""
    if axis is None or size <= 1 or len(shape) < 1:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d >= size and d % size == 0 and (best is None or d >= shape[best]):
            best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


def param_specs(cfg, mesh, params_shape, strategy: str = "auto"):
    """Spec tree for a params tree (tensor parallelism).  Leaves are
    anything with a ``shape``: tensors, fake tensors or ``layers.Leaf``."""
    rules = make_rules(cfg, mesh, strategy=strategy)
    axis = rules.get("vocab")                     # the model axis, if enabled
    size = _axis_size(mesh, axis)
    return tree_map(lambda leaf: _leaf_spec(_shape(leaf), axis, size),
                    params_shape)


def opt_state_specs(cfg, mesh, params_shape, pspecs, strategy: str = "auto"):
    """ZeRO-1-style specs for optimizer moments: keep the tensor-parallel
    split and spread one replicated dim across the data axis."""
    data = "data" if _axis_size(mesh, "data") > 1 else None
    dsize = _axis_size(mesh, data)

    def widen(leaf, spec: Spec) -> Spec:
        shape = _shape(leaf)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if data is None or data in entries:
            return tuple(entries) if any(entries) else ()
        best = None
        for i, d in enumerate(shape):
            if entries[i] is None and d >= dsize and d % dsize == 0 \
                    and (best is None or d >= shape[best]):
                best = i
        if best is not None:
            entries[best] = data
        return tuple(entries) if any(entries) else ()

    return tree_map(widen, params_shape, pspecs)


def named(mesh, specs):
    """Spec tree -> tree of DTensor placements on ``mesh``."""
    return tree_map(lambda s: placements(mesh, s), specs)


def batch_input_shardings(mesh, batch_spec, rules):
    """Specs splitting the leading (batch) dim of every input leaf on the
    data axis."""
    axis = rules.get("batch")
    size = _axis_size(mesh, axis)

    def leaf(l) -> Spec:
        shape = _shape(l)
        if axis and shape and shape[0] >= size and shape[0] % size == 0:
            return (axis,) + (None,) * (len(shape) - 1)
        return ()

    return tree_map(leaf, batch_spec)


def cache_specs(cfg, mesh, cache_shape, rules):
    """Specs for stacked decode caches: leaves are (layers, batch, ...) --
    shard the batch dim (axis 1) on the data axis when it divides."""
    axis = rules.get("batch")
    size = _axis_size(mesh, axis)

    def leaf(l) -> Spec:
        shape = _shape(l)
        if axis and len(shape) >= 2 and shape[1] >= size \
                and shape[1] % size == 0:
            spec = [None] * len(shape)
            spec[1] = axis
            return tuple(spec)
        return ()

    return tree_map(leaf, cache_shape)


# ------------------------------------------------------------ placement
def distribute(tree, mesh, placements_tree):
    """Place every tensor of ``tree`` on ``mesh`` by the matching
    placements.  Every rank holds the same full tensor (drawn from one
    seed), so each keeps its own shard of it, with no communication."""
    from torch.distributed.tensor import DTensor

    def place(t, pl):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return DTensor.from_local(_local_shard(t, mesh, pl), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return tree_map(place, tree, placements_tree)


def _local_shard(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under placements ``pl``
    (even splits: the spec functions shard only dims that divide)."""
    coord = mesh.get_coordinate()
    local = t
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            chunk = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[i] * chunk, chunk)
    return local.contiguous() if local is not t else local


def gather(tree):
    """Every DTensor of ``tree`` as the full tensor (replicated, then
    local): what a checkpoint writes."""
    from torch.distributed.tensor import DTensor

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    return tree_map(full, tree)

