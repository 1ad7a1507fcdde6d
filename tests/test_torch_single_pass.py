"""The rest of Algorithm 1 in the port against the reference: hand-built
``List[Inst]`` traces (twins of ``tests/test_idg_offload.py``), the
columnar-vs-row equivalence of ``tests/test_columnar.py``'s
``_check_equivalence`` inside the port and across the two packages, the
single-pass (placement-dependent) configs on the 17 workloads against the
committed reference records, and the reference's ``select_candidates``
signature.

Each hand-built case builds the same trace with each package's ``Inst``
and compares the two packages' answers with ==, the priced floats
included."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import trace_program as ref_trace_program
from repro.core.cache import CacheHierarchy as RefHierarchy
from repro.core.idg import IDGBuilder as RefBuilder
from repro.core.idg import _build_flow_rows as ref_flow_rows
from repro.core.isa import Inst as RefInst
from repro.core.isa import unit_for as ref_unit_for
from repro.core.offload import OffloadConfig as RefConfig
from repro.core.offload import select_candidates as ref_select
from repro.core.profiler import profile_system as ref_profile
from repro.core.reshape import reshape as ref_reshape

torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch.core import CIM_SET_STT
from repro_torch.core.cache import CacheHierarchy
from repro_torch.core.columnar import ColumnarTrace
from repro_torch.core.idg import (IDGBuilder, _build_flow_rows,
                                  build_flow_index)
from repro_torch.core.isa import SRC_IMM, SRC_REG, Inst, unit_for
from repro_torch.core.offload import (OffloadConfig, TraceAnalysis,
                                      analyze_trace, select_candidates)
from repro_torch.core.profiler import profile_system
from repro_torch.core.reshape import reshape
from repro_torch.core.trace import TraceResult, attach_cache_results
from repro_torch.workloads import fixtures

PACKAGES = {"ref": (RefInst, ref_unit_for), "port": (Inst, unit_for)}


def _mk(pkg, seq, op, dst, srcs, addr=None, level="L1", bank=0):
    inst_cls, unit = PACKAGES[pkg]
    i = inst_cls(seq, op, unit(op, False), "i", dst, srcs, addr=addr)
    i.level, i.hit, i.bank = level, True, bank
    return i


def _paper_fig6_trace(pkg):
    """load r1<-A; load r2<-B; add r0 = r1+r2; store r0->C  (Fig. 3/6)."""
    trace = [
        _mk(pkg, 0, "load", 1, ((SRC_IMM, 0x100),), addr=0x100),
        _mk(pkg, 1, "load", 2, ((SRC_IMM, 0x200),), addr=0x200),
        _mk(pkg, 2, "add", 0, ((SRC_REG, 1), (SRC_REG, 2))),
        _mk(pkg, 3, "store", None, ((SRC_REG, 0),), addr=0x300),
    ]
    rut = {0: [2], 1: [0], 2: [1]}
    iht = {0: [], 1: [], 2: [(1, 0), (2, 0)], 3: [(0, 0)]}
    return trace, rut, iht


def _composite_trace(pkg):
    """(A+B)^C with the add forwarded in-register (Fig. 4(c))."""
    trace = [
        _mk(pkg, 0, "load", 1, ((SRC_IMM, 0x100),), addr=0x100),
        _mk(pkg, 1, "load", 2, ((SRC_IMM, 0x200),), addr=0x200),
        _mk(pkg, 2, "add", 3, ((SRC_REG, 1), (SRC_REG, 2))),
        _mk(pkg, 3, "store", None, ((SRC_REG, 3),), addr=0x300),
        _mk(pkg, 4, "load", 4, ((SRC_IMM, 0x400),), addr=0x400),
        _mk(pkg, 5, "xor", 5, ((SRC_REG, 3), (SRC_REG, 4))),
        _mk(pkg, 6, "store", None, ((SRC_REG, 5),), addr=0x500),
    ]
    rut = {1: [0], 2: [1], 3: [2], 4: [4], 5: [5]}
    iht = {0: [], 1: [], 2: [(1, 0), (2, 0)], 3: [(3, 0)], 4: [],
           5: [(3, 0), (4, 0)], 6: [(5, 0)]}
    return trace, rut, iht


def _split_level_trace(pkg):
    """Operands split L1/L2: offload at L2 with one writeback move."""
    trace = [
        _mk(pkg, 0, "load", 1, ((SRC_IMM, 0x100),), addr=0x100, level="L1"),
        _mk(pkg, 1, "load", 2, ((SRC_IMM, 0x200),), addr=0x200, level="L2"),
        _mk(pkg, 2, "add", 0, ((SRC_REG, 1), (SRC_REG, 2))),
        _mk(pkg, 3, "store", None, ((SRC_REG, 0),), addr=0x300, level="L1"),
    ]
    rut = {0: [2], 1: [0], 2: [1]}
    iht = {2: [(1, 0), (2, 0)], 3: [(0, 0)], 0: [], 1: []}
    return trace, rut, iht


def _both(build, cfg_kw=None):
    """Select on the same hand-built trace in both packages; returns
    (ref result, port result, port trace, rut, iht)."""
    cfg_kw = cfg_kw or {}
    rt, rr, ri = build("ref")
    pt, pr, pi = build("port")
    ref = ref_select(rt, rr, ri, RefConfig(**cfg_kw))
    port = select_candidates(pt, pr, pi, OffloadConfig(**cfg_kw))
    assert [fixtures.candidate_tuple(c) for c in port.candidates] == \
        [fixtures.candidate_tuple(c) for c in ref.candidates]
    assert port.claimed == ref.claimed
    return ref, port, pt, pr, pi


def _forest_shape(forest):
    """Comparable structure of an IDG forest: node seqs + leaf payloads."""
    def node_shape(node):
        out = [("op", node.inst.seq)]
        for kind, payload in node.children:
            if kind == "node":
                out.append(("sub", node_shape(payload)))
            elif kind in ("load", "memval"):
                out.append((kind, payload.seq))
            else:
                out.append((kind, payload))
        return out

    return [node_shape(t) for t in forest]


# ------------------------------------------- twins of test_idg_offload.py
def test_algorithm2_basic_tree():
    trace, rut, iht = _paper_fig6_trace("port")
    b = IDGBuilder(trace, rut, iht)
    tree = b.create_tree(trace[2], CIM_SET_STT)
    assert tree is not None
    kinds = [k for k, _ in tree.children]
    assert kinds == ["load", "load"]               # Fig. 4(a)
    assert [l.seq for l in tree.load_leaves()] == [0, 1]
    assert tree.left == tree.children[0] and tree.right == tree.children[1]
    assert tree.size_ops() == 1
    rt, rr, ri = _paper_fig6_trace("ref")
    assert _forest_shape(b.build_forest(CIM_SET_STT)) == \
        _forest_shape(RefBuilder(rt, rr, ri).build_forest(CIM_SET_STT))


def test_row_builder_needs_rut_and_iht():
    trace, _, _ = _paper_fig6_trace("port")
    with pytest.raises(ValueError, match="RUT/IHT"):
        IDGBuilder(trace)


def test_algorithm1_selects_the_candidate():
    _, res, *_ = _both(_paper_fig6_trace)
    assert len(res.candidates) == 1
    c = res.candidates[0]
    assert c.op_seqs == [2] and c.load_seqs == [0, 1]
    assert c.store_seqs == [3] and c.level == "L1"
    assert c.op_classes == ["CiM-ADD"]
    # all four host instructions leave the pipeline
    assert res.claimed == {0, 1, 2, 3}


def test_composite_pattern_merges():
    _, res, *_ = _both(_composite_trace)
    assert len(res.candidates) == 1
    c = res.candidates[0]
    assert sorted(c.op_seqs) == [2, 5]             # composite subtree
    assert sorted(c.load_seqs) == [0, 1, 4]
    assert c.op_classes.count("CiM-ADD") == 1


def test_level_lifting_and_moves():
    _, res, *_ = _both(_split_level_trace)
    c = res.candidates[0]
    assert c.level == "L2" and c.moves == 1
    # L1-only CiM cannot host it without cross-level support
    _, res2, *_ = _both(_split_level_trace, {"cim_levels": ("L1",)})
    assert res2.candidates and res2.candidates[0].level == "L1"
    _, res3, *_ = _both(_split_level_trace, {"allow_cross_level": False})
    assert not res3.candidates


@pytest.mark.parametrize("bank, n_candidates", [(3, 0), (0, 1)])
def test_same_bank_requirement(bank, n_candidates):
    def build(pkg):
        trace, rut, iht = _paper_fig6_trace(pkg)
        trace[1].bank = bank                        # operands in 0 / bank
        return trace, rut, iht
    _, res, *_ = _both(build, {"require_same_bank": True})
    assert len(res.candidates) == n_candidates


def test_non_cim_ops_not_offloaded():
    def build(pkg):
        trace, rut, iht = _paper_fig6_trace(pkg)
        trace[2].op = "div"                         # not CiM-supported
        return trace, rut, iht
    _, res, *_ = _both(build)
    assert not res.candidates


@pytest.mark.parametrize("build", [_paper_fig6_trace, _composite_trace,
                                   _split_level_trace],
                         ids=["fig6", "composite", "split_level"])
def test_row_reshape_and_pricing_equal_reference(build):
    """Reshape and the per-``Inst`` pricing loop of a row trace, in SRAM
    and FeFET: every priced float == the reference's."""
    ref, port, pt, pr, pi = _both(build)
    rt, rr, ri = build("ref")
    shaped = reshape(pt, port)
    ref_shaped = ref_reshape(rt, ref)
    assert shaped.host_seqs.dtype == torch.int64
    assert shaped.host_seqs.device.type == "cpu"
    assert shaped.host_seqs.tolist() == ref_shaped.host_seqs
    assert [(g.level, g.op_classes) for g in shaped.cim_groups] == \
        [(g.level, g.op_classes) for g in ref_shaped.cim_groups]
    ref_tr = types.SimpleNamespace(trace=rt, rut=rr, iht=ri,
                                   cache=RefHierarchy())
    tr = TraceResult(pt, CacheHierarchy(), [], rut=pr, iht=pi)
    for tech in fixtures.TECHS:
        want = ref_profile(ref_tr, RefConfig(), tech)
        got = profile_system(tr, OffloadConfig(), tech)
        assert got.base.__dict__ == want.base.__dict__
        assert got.cim.__dict__ == want.cim.__dict__
        assert (got.base_cycles, got.cim_cycles) == \
            (want.base_cycles, want.cim_cycles)
        assert fixtures.report_record(got) == fixtures.report_record(want)
    # the row analysis bundle answers the same
    an = analyze_trace(tr)
    assert isinstance(an, TraceAnalysis) and an.rut is pr and an.iht is pi
    assert [fixtures.candidate_tuple(c) for c in an.select().candidates] \
        == [fixtures.candidate_tuple(c) for c in port.candidates]


@settings(max_examples=10, deadline=None)
@given(st.integers(4, 32), st.integers(0, 10))
def test_property_invariants_random_programs(n, seed):
    """The reference's random programs, their rows selected by both
    packages: == each other, claims disjoint, MACR within [0, 1]."""
    r = np.random.default_rng(seed)
    a = jnp.asarray(r.integers(0, 100, (n,)), jnp.int32)
    b = jnp.asarray(r.integers(0, 100, (n,)), jnp.int32)

    def f(a, b):
        return jnp.sum((a + b) ^ (a - b) | b)
    tr = ref_trace_program(f, a, b)
    ref = ref_select(list(tr.trace), tr.rut, tr.iht)
    ct = ColumnarTrace.from_arrays(tr.trace.to_arrays(), device="cpu")
    rows = list(ct)
    res = select_candidates(rows, ct.rut, ct.iht)
    assert [fixtures.candidate_tuple(c) for c in res.candidates] == \
        [fixtures.candidate_tuple(c) for c in ref.candidates]
    assert res.claimed == ref.claimed
    seen = set()
    for c in res.candidates:
        ids = set(c.op_seqs) | set(c.load_seqs) | set(c.store_seqs)
        assert not (ids & seen)
        seen |= ids
        assert c.converted_accesses >= 1
    mb = res.macr_breakdown(rows)
    assert 0.0 <= mb["macr"] <= 1.0
    assert mb["converted"] <= mb["total_accesses"]
    assert mb == ref.macr_breakdown(list(tr.trace))
    assert res.macr(rows) == ref.macr(list(tr.trace))


# ------------------------------------------- twins of test_columnar.py
def _variant_a(n):          # Load-Load-OP-Store: both operands from memory
    a = jnp.arange(n, dtype=jnp.int32)
    b = jnp.arange(n, dtype=jnp.int32) * 2
    return (lambda a, b: (a + b) ^ a), (a, b)


def _variant_b(n):          # Load-Imm-OP-Store: literal lowers to immediate
    a = jnp.arange(n, dtype=jnp.int32)
    return (lambda a: (a & 7) + 3), (a,)


def _variant_c(n):          # OP-(reg)-OP chains: reduction accumulators
    a = jnp.asarray(np.random.default_rng(0).integers(0, 50, n), jnp.int32)
    return (lambda a: jnp.sum((a + 1) ^ a)), (a,)


CONFIGS = {"default": {},
           "same_bank": fixtures.SINGLE_PASS_CONFIGS["same_bank"],
           "no_cross_level_L1":
               fixtures.SINGLE_PASS_CONFIGS["no_cross_level_L1"]}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("variant", [_variant_a, _variant_b, _variant_c],
                         ids=["load_load_op", "load_imm_op", "reg_chain"])
def test_rows_equal_columns_and_reference(variant, config):
    """``_check_equivalence``: rows == columns inside the port (flow dicts,
    forests, candidates, claimed, reshape; priced reports as the reference
    holds its own two paths), and each path == the reference's."""
    fn, args = variant(32 if variant is _variant_a else 24)
    rtr = ref_trace_program(fn, *args)
    ref_ct = rtr.trace
    ref_rows = list(ref_ct)
    ct = ColumnarTrace.from_arrays(ref_ct.to_arrays(), device="cpu")
    rows = list(ct)
    rut, iht = ct.rut, ct.iht
    assert rut == rtr.rut and iht == rtr.iht
    cfg, ref_cfg = OffloadConfig(**CONFIGS[config]), \
        RefConfig(**CONFIGS[config])

    # flow maps: vectorized == object-at-a-time == the reference's
    fast, slow = build_flow_index(ct), _build_flow_rows(rows, rut, iht)
    ref_slow = ref_flow_rows(ref_rows, rtr.rut, rtr.iht)
    for view in ("reg_consumers", "store_of", "load_source", "value_loads"):
        assert getattr(fast, view) == getattr(slow, view) \
            == getattr(ref_slow, view)
    assert {k: v.tolist() for k, v in slow.to_arrays().items()} == \
        {k: v.tolist() for k, v in ref_slow.to_arrays().items()}

    # producers of every register source slot, and IDG forests
    col_b, row_b = IDGBuilder(ct), IDGBuilder(rows, rut, iht)
    ref_b = RefBuilder(ref_ct)
    for seq in range(len(rows)):
        for slot in range(3):
            got = [b.producer_of(seq, slot) for b in (col_b, row_b, ref_b)]
            assert len({None if p is None else p.seq for p in got}) == 1
    shape = _forest_shape(IDGBuilder(ct).build_forest(cfg.cim_set))
    assert shape == _forest_shape(IDGBuilder(rows, rut, iht).build_forest(
        cfg.cim_set)) == _forest_shape(RefBuilder(ref_ct).build_forest(
            ref_cfg.cim_set))

    # Algorithm 1, reshape and pricing: columns, rows, reference
    col = select_candidates(ct, cfg=cfg, device="cpu")
    row = select_candidates(rows, rut, iht, cfg)
    ref_col = ref_select(ref_ct, cfg=ref_cfg)
    ref_row = ref_select(ref_rows, rtr.rut, rtr.iht, ref_cfg)
    tuples = [fixtures.candidate_tuple(c) for c in col.candidates]
    for other in (row, ref_col, ref_row):
        assert [fixtures.candidate_tuple(c) for c in other.candidates] == \
            tuples
        assert other.claimed == col.claimed
    col_rs, row_rs = reshape(ct, col), reshape(rows, row)
    assert col_rs.host_seqs.tolist() == row_rs.host_seqs.tolist() == \
        ref_reshape(ref_ct, ref_col).host_seqs
    for f in ("cim_groups", "moves", "internal_moves", "added_loads",
              "dram_fills", "n_offloaded"):
        assert getattr(col_rs, f) == getattr(row_rs, f)

    col_tr = TraceResult(ct, CacheHierarchy(), [])
    row_tr = TraceResult(rows, CacheHierarchy(), [], rut=rut, iht=iht)
    ref_row_tr = types.SimpleNamespace(trace=ref_rows, rut=rtr.rut,
                                       iht=rtr.iht, cache=rtr.cache)
    rep_col = profile_system(col_tr, cfg, offload=col, reshaped=col_rs,
                             device="cpu")
    rep_row = profile_system(row_tr, cfg, offload=row, reshaped=row_rs)
    assert fixtures.report_record(rep_col) == fixtures.report_record(
        ref_profile(rtr, ref_cfg, offload=ref_col,
                    reshaped=ref_reshape(ref_ct, ref_col)))
    assert fixtures.report_record(rep_row) == fixtures.report_record(
        ref_profile(ref_row_tr, ref_cfg, offload=ref_row,
                    reshaped=ref_reshape(ref_rows, ref_row)))
    assert rep_col.energy_improvement == \
        pytest.approx(rep_row.energy_improvement)
    assert rep_col.speedup == pytest.approx(rep_row.speedup)
    assert rep_col.macr == rep_row.macr


# ------------------------------- the 17 workloads, single-pass configs
@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_single_pass_on_workloads_equals_reference_fixture(name):
    """Both single-pass configs on the reference trace of ``name`` at
    32K+256K, priced in SRAM and FeFET, == the committed reference
    records (what ``chip_smoke.py`` phase 10 holds on the card)."""
    want = [r for r in fixtures.reference_single_pass()["records"]
            if r["workload"] == name]
    tr = attach_cache_results(
        fixtures.load_structural(name, device="cpu"),
        fixtures.CACHES[fixtures.SINGLE_PASS_CACHE], device="cpu")
    got = []
    for config, kw in fixtures.SINGLE_PASS_CONFIGS.items():
        cfg = OffloadConfig(**kw)
        res = select_candidates(tr.trace, cfg=cfg, device="cpu")
        shaped = reshape(tr.trace, res)
        got += fixtures.single_pass_records(
            name, config, res,
            {tech: profile_system(tr, cfg, tech, offload=res,
                                  reshaped=shaped, device="cpu")
             for tech in fixtures.TECHS})
    assert got == want


# ------------------------------------------------- the signature
def test_offload_config_in_rut_position_raises_type_error():
    trace, rut, iht = _paper_fig6_trace("port")
    with pytest.raises(TypeError, match="OffloadConfig as 'rut'"):
        select_candidates(trace, OffloadConfig())
    with pytest.raises(TypeError, match="OffloadConfig as 'iht'"):
        select_candidates(trace, rut, OffloadConfig())
    with pytest.raises(TypeError, match="cfg must be an OffloadConfig"):
        select_candidates(trace, rut, iht, {"require_same_bank": True})
    # the reference's call works unchanged
    assert select_candidates(trace, rut, iht,
                             OffloadConfig(require_same_bank=True)).claimed \
        == {0, 1, 2, 3}
