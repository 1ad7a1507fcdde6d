"""repro_torch.core.hlo / hlo_cost against repro.core.hlo (twin of the
fusion and roofline cases of ``tests/test_hlo_roofline.py``).

Layer 1 of the accelerator-mode backend walks a recorded ATen graph where
the reference walks a jaxpr.  On toy graphs built the same way in jnp and
in torch the two graphs have the same equations in the same order, so
:func:`fusion_candidates` must give the reference's report field for
field.  On a real arch they differ by design (ROADMAP Queue 3), so there
the graph's FLOPs are held to ``torch.utils.flop_counter.FlopCounterMode``
-- an independent count -- for all ten reduced archs.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port
from torch.utils.flop_counter import FlopCounterMode

from repro.core import hlo as ref_hlo

from repro_torch.configs.registry import ARCHS, reduced_config
from repro_torch.core import hlo
from repro_torch.core.hlo import GraphRecorder, fusion_candidates, record_graph
from repro_torch.core.hlo_cost import analyze_graph
from repro_torch.core.tpu_model import (V5E, model_flops, roofline_terms,
                                        step_energy_pj)
from repro_torch.dse.backends import analyze_train_step, record_train_step

_RNG = np.random.default_rng(0)


def _a(*shape, dtype=np.float32):
    return _RNG.standard_normal(shape).astype(dtype)


#: (jnp function, torch function, numpy inputs): the same graph in both
TOYS = {
    # test_hlo_roofline.py's chain: a matmul ends an elementwise chain
    "chain": (lambda x, y: jnp.tanh((x + y) * 2.0) @ y.T,
              lambda x, y: torch.tanh((x + y) * 2.0) @ y.T,
              (_a(256, 256), _a(256, 256))),
    # test_hlo_roofline.py's multi-consumer case
    "multi_consumer": (lambda x: (lambda a: a * 2.0 + jnp.tanh(a))(x + 1.0),
                       lambda x: (lambda a: a * 2.0 + torch.tanh(a))(x + 1.0),
                       (_a(512, 512),)),
    # a view inside a chain
    "view_in_chain": (lambda x, y: jnp.exp((x + y).reshape(128, 512)) * 3.0,
                      lambda x, y: torch.exp((x + y).reshape(128, 512)) * 3.0,
                      (_a(256, 256), _a(256, 256))),
    # a terminal reduction
    "terminal_reduction": (lambda x, y: jnp.sum(jnp.exp(x) * y, axis=-1),
                           lambda x, y: torch.sum(torch.exp(x) * y, dim=-1),
                           (_a(256, 256), _a(256, 256))),
    # a chain fed by a matmul, with an explicitly broadcast bias
    "matmul_feeds_chain": (
        lambda x, w, b: jnp.tanh(x @ w + jnp.broadcast_to(b, (256, 256))) - x,
        lambda x, w, b: torch.tanh(x @ w + b.expand(256, 256)) - x,
        (_a(256, 256), _a(256, 256), _a(256))),
    # every input under min_bytes: a candidate that moves no counted byte
    "under_min_bytes": (lambda x, y: jnp.exp(x * y + 1.0),
                        lambda x, y: torch.exp(x * y + 1.0),
                        (_a(16, 16), _a(16, 16))),
    # dtype conversions (views in both) inside a chain
    "convert_in_chain": (
        lambda x, y: (x.astype(jnp.bfloat16) * 2).astype(jnp.float32) + y,
        lambda x, y: (x.to(torch.bfloat16) * 2).to(torch.float32) + y,
        (_a(256, 256), _a(256, 256))),
    # a transposed input read twice
    "transpose_twice": (lambda x, y: jnp.sqrt(jnp.abs(x.T - y)) * x.T,
                        lambda x, y: torch.sqrt(torch.abs(x.T - y)) * x.T,
                        (_a(128, 256), _a(256, 128))),
}


def _report(rep):
    return {"total_bytes": rep.total_bytes, "saved_bytes": rep.saved_bytes,
            "tpu_macr": rep.tpu_macr,
            "candidates": [(c.eqn_ids, c.ops, c.n_ops, c.input_bytes,
                            c.output_bytes, c.saved_bytes)
                           for c in rep.candidates]}


def _both(name, min_bytes=1 << 12):
    jfn, tfn, arrays = TOYS[name]
    jx = jax.make_jaxpr(jfn)(*arrays)
    graph, _ = record_graph(tfn, *(torch.from_numpy(a) for a in arrays))
    return (jx, ref_hlo.fusion_candidates(jx, min_bytes), graph,
            fusion_candidates(graph, min_bytes))


@pytest.mark.parametrize("min_bytes", [1 << 12, 64, 1 << 20])
@pytest.mark.parametrize("name", TOYS)
def test_fusion_candidates_equal_reference_on_toy_graphs(name, min_bytes):
    jx, want, graph, got = _both(name, min_bytes)
    assert [e.prim for e in graph.eqns] == \
        [e.primitive.name for e in jx.jaxpr.eqns]
    assert _report(got) == _report(want)


def test_fusion_candidates_chain():
    _jx, _want, _graph, rep = _both("chain")
    assert rep.candidates, "elementwise chain must be found"
    big = max(rep.candidates, key=lambda c: c.n_ops)
    assert big.n_ops >= 3
    # two intermediates (a, b) * 2 (store+load) * 256KB
    assert big.saved_bytes == 2 * 2 * 256 * 256 * 4
    assert 0.0 < rep.tpu_macr < 1.0


def test_fusion_respects_multi_consumer():
    _jx, _want, _graph, rep = _both("multi_consumer")
    for c in rep.candidates:
        assert c.saved_bytes >= 0


def test_implicit_broadcast_is_an_eqn_in_the_jaxpr_only():
    """jnp writes the implicit broadcast of a bias as a ``broadcast_in_dim``
    eqn (to 1 x 256); ATen broadcasts inside ``add``.  The traffic is the
    same, but the chain differs (ROADMAP Queue 3): the reference's chain
    takes in the view, and its rule that the outputs of the last eqn the
    walk reaches are written then counts the 1 KB view (under min_bytes)
    where the port's counts the 256 KB sum."""
    x, b = _a(256, 256), _a(256)
    jx = jax.make_jaxpr(lambda x, b: jnp.exp(x + b) * 2.0)(x, b)
    graph, _ = record_graph(lambda x, b: torch.exp(x + b) * 2.0,
                            torch.from_numpy(x), torch.from_numpy(b))
    assert [e.primitive.name for e in jx.jaxpr.eqns] == \
        ["broadcast_in_dim", "add", "exp", "mul"]
    assert [e.prim for e in graph.eqns] == ["add", "exp", "mul"]
    want, got = ref_hlo.fusion_candidates(jx), fusion_candidates(graph)
    assert want.total_bytes == got.total_bytes
    (w,), (g,) = want.candidates, got.candidates
    assert (w.saved_bytes, w.input_bytes) == (g.saved_bytes, g.input_bytes)
    assert (w.output_bytes, g.output_bytes) == (0, 256 * 256 * 4)


def test_in_place_op_writes_a_new_value():
    def fn(x):
        y = x * 2.0
        y.add_(1.0)
        return torch.exp(y)
    graph, _ = record_graph(fn, torch.zeros(64, 64))
    mul, add_, exp = graph.eqns
    assert (mul.prim, add_.prim, exp.prim) == ("mul", "add", "exp")
    assert add_.invars == mul.outvars
    assert add_.outvars != mul.outvars and exp.invars == add_.outvars
    rep = fusion_candidates(graph)
    assert [c.ops for c in rep.candidates] == [["mul", "add", "exp"]]


def test_unknown_ops_are_other_and_the_table_names_real_ops():
    graph, _ = record_graph(lambda x: torch.cat([x, x]).cumsum(0),
                            torch.zeros(8, 8))
    assert [(e.prim, e.klass) for e in graph.eqns] == \
        [("aten.cat", "other"), ("cumsum", "reduction")]
    for prim, atens in hlo.ATEN_TWINS.items():
        assert hlo.klass_of(prim) != "other", prim
        for name in atens:
            assert hasattr(torch.ops.aten, name), name


def test_recorder_keeps_no_tensor_alive():
    """Every intermediate of a recorded function is freed when it returns:
    the recorder keeps shapes and dtypes, and its identity map is weak."""
    refs = []

    def fn(x):
        for _ in range(4):
            x = torch.tanh(x + 1.0)
            refs.append(weakref.ref(x))
        return x.sum()

    x = torch.zeros(128, 128)
    rec = GraphRecorder()
    with rec:
        fn(x)
    gc.collect()
    assert all(r() is None for r in refs)
    assert list(rec._ids.values()) == [0]          # x alone is alive
    assert len(rec.graph().eqns) == 9


@pytest.mark.parametrize("op", ["mm", "addmm", "bmm", "baddbmm"])
def test_matmul_flops_equal_flop_counter(op):
    a, b = torch.zeros(3, 5, 7), torch.zeros(3, 7, 11)
    calls = {"mm": lambda: torch.mm(a[0], b[0]),
             "addmm": lambda: torch.addmm(torch.zeros(5, 11), a[0], b[0]),
             "bmm": lambda: torch.bmm(a, b),
             "baddbmm": lambda: torch.baddbmm(torch.zeros(3, 5, 11), a, b)}
    with FlopCounterMode(display=False) as fc:
        graph, _ = record_graph(calls[op])
    flops = analyze_graph(graph).flops
    assert flops == fc.get_total_flops() == 2 * 5 * 7 * 11 * \
        (1 if op in ("mm", "addmm") else 3)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_flops_equal_flop_counter(arch):
    """The graph's FLOPs of a reduced arch's train step (B=2, S=32) equal
    FlopCounterMode's count of the same run, and are above 0 (the
    reference's HLO count reads 0 on this jax, ROADMAP Queue 3)."""
    with FlopCounterMode(display=False) as fc:
        an = analyze_train_step(reduced_config(arch), 2, 32, "cpu")
    assert an.flops == fc.get_total_flops() > 0
    assert an.workload == arch and an.collective_bytes == 0
    assert an.n_eqns > 0 and an.candidates
    assert 0 < sum(c.saved_bytes for c in an.candidates) < an.total_bytes
    assert an.hlo_bytes > 0


def test_recorder_sees_the_backward():
    """The train step's graph holds the backward: more than three times
    the forward's matrix products and FLOPs (forward, the block remat's
    recompute, and the two products of each backward)."""
    from repro_torch.models import inputs as minputs
    from repro_torch.train import steps
    cfg = reduced_config("qwen1.5-0.5b")
    full = record_train_step(cfg, 2, 32, "cpu")
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(gen, cfg, device="cpu")
    batch = minputs.make_train_batch(gen, cfg, 2, 32, device="cpu")
    with torch.no_grad():
        fwd, _ = record_graph(steps.loss_fn, state["params"], cfg, batch)

    def n_mm(g):
        return sum(e.prim == "dot_general" for e in g.eqns)

    assert n_mm(full) > 3 * n_mm(fwd) > 0
    assert analyze_graph(full).flops > 3 * analyze_graph(fwd).flops


def test_roofline_terms_math():
    t = roofline_terms(197e12, 819e9, 50e9, 256)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0)
    t2 = roofline_terms(197e12 * 3, 819e9, 0, 8)
    assert t2.dominant == "compute"
    assert t2.bound_s == pytest.approx(3.0)
    assert 0 < t2.roofline_fraction <= 1.0
    assert roofline_terms(1.0, 1.0, 1.0, 1, chip=V5E) == \
        roofline_terms(1.0, 1.0, 1.0, 1)


def test_model_flops():
    assert model_flops(1_000, 10, "train") == 6e4
    assert model_flops(1_000, 10, "serve") == 2e4
    e = step_energy_pj(1e12, 1e9, 1e6, 4)
    assert e["total_pj"] == pytest.approx(
        e["compute_pj"] + e["hbm_pj"] + e["ici_pj"])
