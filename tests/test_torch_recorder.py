"""The graph recorder (``core/hlo.py::GraphRecorder``) against a copy of the
recorder it replaced, which walked every op's arguments and result with
pytree, kept tensors in a ``WeakIdKeyDictionary`` and built one ``Eqn``
per op as it ran: both record graphs ``==`` (eqns, shapes, element sizes)
on the Granite kind's small train step, hymba's reduced step, a DTensor
cell on a fake mesh and a set of ops chosen for their arguments.  Also the
recorder's count of the eqns it found by a pytree walk
(``fallback_eqns``), on the recorder and on the ``tpu.record`` span.

Nothing here imports JAX.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from cimbench.accel_port import program_config
from cimbench.kinds import accel
from repro_torch import obs
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.core import hlo
from repro_torch.core.hlo import GraphRecorder
from repro_torch.dse import backends
from repro_torch.models import inputs as minputs
from repro_torch.train import steps

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG_FILE = ROOT / "cimbench" / "configs" / "granite-4.0-h-small-ep8.json"
aten = torch.ops.aten


# ------------------------------------------------------------ the oracle
class PytreeRecorder(TorchDispatchMode):
    """The recorder before per-op plans, verbatim but for its names: every
    op's tensors found by ``tree_leaves``, a weak-keyed identity map, one
    :class:`~repro_torch.core.hlo.Eqn` built per op."""

    def __init__(self):
        super().__init__()
        self.eqns = []
        self.shapes = []
        self.itemsizes = []
        self._ids = WeakIdKeyDictionary()
        self._ops = {}
        self._lock = threading.Lock()

    def _new_value(self, t):
        vid = len(self.shapes)
        self.shapes.append(tuple(t.shape))
        self.itemsizes.append(t.element_size())
        self._ids[t] = vid
        return vid

    def _read(self, t):
        vid = self._ids.get(t)
        return self._new_value(t) if vid is None else vid

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor for t in types):
            if any(issubclass(t, hlo._dtensor_type()) for t in types):
                return NotImplemented
            if any(issubclass(t, hlo._fake_type()) for t in types):
                return func(*args, **kwargs)
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
                self.eqns.append(hlo.Eqn(prim, str(func), ins, outs))
        return out

    def graph(self):
        with self._lock:
            return hlo.Graph(list(self.eqns), list(self.shapes),
                             list(self.itemsizes))


def _op_info(func):
    writes = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write)
    return hlo.primitive_of(func), writes


def _written(writes, args, kwargs):
    out = []
    for i, name in writes:
        val = args[i] if i < len(args) else kwargs.get(name)
        out.extend(t for t in tree_leaves(val)
                   if isinstance(t, torch.Tensor))
    return out


# ------------------------------------------------------------ helpers
def record(recorder_cls, fn, *args):
    rec = recorder_cls()
    with rec:
        fn(*args)
    return rec, rec.graph()


def assert_records_as_before(fn, *args):
    """``fn(*args)`` recorded by both recorders, in turns: the graphs are
    ``==``.  Returns the new recorder and its graph."""
    _, want = record(PytreeRecorder, fn, *args)
    rec, got = record(GraphRecorder, fn, *args)
    assert len(got.eqns) == len(want.eqns)
    assert got.eqns == want.eqns
    assert got.shapes == want.shapes
    assert got.itemsizes == want.itemsizes
    return rec, got


def train_step(cfg, batch, seq_len):
    """A train step, its state and batch as ``record_train_step`` makes
    them, run once unrecorded so that nothing lazy happens only in the
    first recording."""
    gen = torch.Generator().manual_seed(1234567)
    state = steps.init_train_state(gen, cfg, device="cpu")
    data = minputs.make_train_batch(gen, cfg, batch=batch, seq_len=seq_len,
                                    device="cpu")
    step = steps.make_train_step(cfg, TrainConfig())
    step(state, data)
    return step, state, data


def tiny_granite():
    doc = accel.tiny_config(json.loads(CONFIG_FILE.read_text()))
    return program_config(doc)


# ------------------------------------------------------------ whole steps
def test_granite_tiny_step_records_as_before():
    """The accel kind's CPU cut of granite (five Mamba-2 layers and an
    attention layer, routed experts, 64 tokens): forward, the remat
    recomputation, backward and AdamW, every op found from its plan."""
    step, state, data = train_step(tiny_granite(), 1, 64)
    rec, graph = assert_records_as_before(step, state, data)
    assert rec.fallback_eqns == 0
    prims = {e.prim for e in graph.eqns}
    assert {"dot_general", "cumsum", "aten.cat"} <= prims
    assert any(e.aten.startswith("aten._foreach") or e.aten.startswith(
        "aten.index") for e in graph.eqns)


def test_hymba_reduced_step_records_as_before():
    step, state, data = train_step(reduced_config("hymba-1.5b"), 2, 32)
    rec, _ = assert_records_as_before(step, state, data)
    assert rec.fallback_eqns == 0


_DTENSOR = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import test_torch_recorder as t
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.core import hlo
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import cells
    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_mesh

    init_fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = reduced_config(sys.argv[2])
    shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
    rules = shd.make_rules(cfg, mesh, shape, strategy="auto")
    cell = cells.build_cell_for(cfg, shape, mesh, rules, strategy="auto")
    made = []

    class New(hlo.GraphRecorder):
        def __init__(self):
            super().__init__()
            made.append(self)

    def graphs(recorder):
        cells.GraphRecorder = recorder
        return cell.record().graph, cell.record_plain()[0].graph

    graphs(New)                          # DTensor's caches filled
    want = graphs(t.PytreeRecorder)
    got = graphs(New)
    print(json.dumps({
        "n_eqns": [len(g.eqns) for g in got],
        "equal": [g == w for g, w in zip(got, want)],
        "fallback_eqns": [r.fallback_eqns for r in made[2:]]}))
""")


def test_dtensor_cell_records_as_before():
    """A reduced arch's train cell on meta DTensors over a fake 2x4 mesh
    (one device's local ops and collectives) and its world-1 record under
    ``FlopCounterMode``, as ``launch/cells.py`` records them."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _DTENSOR, str(ROOT / "tests"),
         "qwen1.5-0.5b"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(n > 0 for n in out["n_eqns"])
    assert out["equal"] == [True, True]
    assert out["fallback_eqns"] == [0, 0]


# ------------------------------------------------------------ single ops
def _sort_out(a):
    v, i = torch.empty(0), torch.empty(0, dtype=torch.long)
    return torch.sort(a, 1, out=(v, i))


def _max_out(a):
    v, i = torch.empty(0), torch.empty(0, dtype=torch.long)
    return torch.max(a, 1, out=(v, i))


def _index_put(a, idx):
    b = a.clone()
    b[:, idx] = 1.0
    b.index_put_((idx,), torch.zeros(a.shape[1]), accumulate=True)
    return aten.index_put.default(b, [None, idx], a[:, :3])


def _write_then_read(a):
    c = a.clone()
    c.view(-1).add_(1.0)
    return c * a


def _fused_adamw(a, b):
    ps, gs = [a.clone(), b.clone()], [b, a]
    m, v = [torch.zeros_like(a)] * 2, [torch.zeros_like(a)] * 2
    steps_ = [torch.tensor(1.0), torch.tensor(1.0)]
    torch._fused_adamw_(ps, gs, m, v, [], steps_, lr=1e-3, beta1=0.9,
                        beta2=0.99, weight_decay=0.1, eps=1e-8,
                        amsgrad=False, maximize=False,
                        grad_scale=torch.tensor(1.0),
                        found_inf=torch.tensor(0.0))
    return ps


def _layer_norm_grads(a):
    mean, rstd = a.mean(1, keepdim=True), a.var(1, keepdim=True).rsqrt()
    return aten.native_layer_norm_backward(a, a, [a.shape[1]], mean, rstd,
                                           None, None, [True, False, False])


OPS = {
    # Tensor[]
    "cat": lambda a, b, idx: torch.cat([a, b, a], 1),
    "stack": lambda a, b, idx: torch.stack([a, b]).sum(0),
    # Tensor?[] with None entries
    "index_none": lambda a, b, idx: (a[:, idx], a[None, idx],
                                     aten.index.Tensor(a, [None, idx])),
    "index_put": lambda a, b, idx: _index_put(a, idx),
    # in place and out=
    "in_place": lambda a, b, idx: a.clone().add_(b).mul_(2.0).clamp_(0.0),
    "out": lambda a, b, idx: torch.add(a, b, out=torch.empty_like(a)),
    "foreach": lambda a, b, idx: (torch._foreach_add_([a.clone(), b.clone()],
                                                      [b, a]),
                                  torch._foreach_mul([a, b], 2.0)),
    # several outputs, tuples with Nones
    "split": lambda a, b, idx: torch.split(a, 2, 1),
    "unbind": lambda a, b, idx: a.unbind(0),
    "max_dim": lambda a, b, idx: torch.max(a, 1),
    "max_dim_out": lambda a, b, idx: _max_out(a),
    "sort": lambda a, b, idx: torch.sort(a, 1),
    "sort_out": lambda a, b, idx: _sort_out(a),
    "layer_norm_backward": lambda a, b, idx: _layer_norm_grads(a),
    # tensors as keyword arguments
    "fused_adamw_kwargs": lambda a, b, idx: _fused_adamw(a, b),
    # numbers in Tensor slots, factories, and ops with no tensor
    "scalars": lambda a, b, idx: (a * 2.0, torch.where(a > 0, a, 0.0),
                                  a.clamp(min=0.0), 1.0 - a),
    "factories": lambda a, b, idx: torch.zeros(2, 3) + torch.arange(3),
    "no_tensor": lambda a, b, idx: torch.result_type(1, 2.0),
    # a tensor read twice, and one written then read
    "aliases": lambda a, b, idx: (a + a, a.t().contiguous() @ a,
                                  _write_then_read(a)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_records_as_before(name):
    a, b = torch.randn(4, 6), torch.randn(4, 6)
    idx = torch.tensor([0, 2, 3])
    rec, graph = assert_records_as_before(OPS[name], a, b, idx)
    assert rec.fallback_eqns == 0
    if name == "no_tensor":
        assert graph.eqns == []
    else:
        assert graph.eqns


@pytest.mark.parametrize("func,args,kwargs", [
    (aten.add.Tensor, ("a",), {"other": "b", "alpha": 2}),
    (aten.cat.default, (), {"tensors": ["a", "b"], "dim": 1}),
    (aten.index.Tensor, ("a",), {"indices": [None, "idx"]}),
    (aten.add.out, ("a", "b"), {"out": "c"}),
], ids=["add_kw", "cat_kw", "index_kw", "add_out"])
def test_named_arguments_record_as_before(func, args, kwargs):
    """Arguments the dispatcher would have passed by position, passed by
    name to the mode itself: the plan reads them by name, in the order
    pytree reads them."""
    vals = {"a": torch.randn(4, 6), "b": torch.randn(4, 6),
            "c": torch.empty(4, 6), "idx": torch.tensor([1, 0])}

    def sub(v):
        if isinstance(v, list):
            return [sub(x) for x in v]
        return vals[v] if isinstance(v, str) and v in vals else v
    args, kwargs = sub(list(args)), {k: sub(v) for k, v in kwargs.items()}
    graphs = []
    for cls in (PytreeRecorder, GraphRecorder):
        rec = cls()
        rec.__torch_dispatch__(func, (torch.Tensor,), tuple(args), kwargs)
        graphs.append(rec.graph())
    assert graphs[0] == graphs[1] and graphs[1].eqns
    assert rec.fallback_eqns == 0


def test_an_unclassified_value_takes_the_pytree_walk():
    """A value of a type the plan does not know (a NumPy scalar where the
    schema says ``Tensor``) sends the op down the pytree walk, which
    records it as before, and is counted; the next op is planned again."""
    a = torch.randn(3)
    graphs, recs = [], []
    for cls in (PytreeRecorder, GraphRecorder):
        rec = cls()
        rec.__torch_dispatch__(aten.add.Tensor, (torch.Tensor,),
                               (a, np.float64(2.0)), {})
        rec.__torch_dispatch__(aten.add.Tensor, (torch.Tensor,), (a, 2.0), {})
        graphs.append(rec.graph())
        recs.append(rec)
    assert graphs[0] == graphs[1] and len(graphs[1].eqns) == 2
    assert recs[1].fallback_eqns == 1


def test_tpu_record_span_carries_fallback_eqns():
    """``record_train_step`` under the port's tracer: the ``tpu.record``
    span carries ``fallback_eqns`` beside ``n_eqns``; 0 on the tiny
    granite step."""
    t = obs.enable(obs.Tracer())
    try:
        graph = backends.record_train_step(tiny_granite(), 1, 64, "cpu")
    finally:
        obs.disable()
    spans = [s for s in t.spans() if s["name"] == "tpu.record"]
    assert len(spans) == 1
    attrs = spans[0]["attrs"]
    assert attrs["n_eqns"] == len(graph.eqns) > 0
    assert attrs["fallback_eqns"] == 0


def test_threads_sharing_a_recorder_lose_no_eqn():
    """Ops recorded from more threads than cores at once (as autograd's
    threads record the backward), with a short switch interval: every op
    is one eqn, every value is written once, and each thread's chain reads
    the value its previous op wrote."""
    n_threads, n_ops = 2 * (os.cpu_count() or 1) + 1, 200
    rec = GraphRecorder()
    chains = {}

    def work(k):
        x, y = torch.full((2,), float(k)), torch.ones(2)
        outs = []
        for _ in range(n_ops):
            x = rec.__torch_dispatch__(aten.add.Tensor, (torch.Tensor,),
                                       (x, y), {})
            outs.append(x)
        chains[k] = outs
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    graph = rec.graph()
    assert len(graph.eqns) == n_threads * n_ops
    written = [v for e in graph.eqns for v in e.outvars]
    assert len(written) == len(set(written))
    producer = {e.outvars[0]: i for i, e in enumerate(graph.eqns)}
    for i, e in enumerate(graph.eqns):
        for v in e.invars:
            assert producer.get(v, -1) < i
    # each thread's ops form one chain: op k+1 reads op k's output value
    assert sum(len(outs) for outs in chains.values()) == n_threads * n_ops
    for e in graph.eqns:
        if e.invars[0] in producer:
            prev = graph.eqns[producer[e.invars[0]]]
            assert prev.invars[1] == e.invars[1]     # the same thread's y
