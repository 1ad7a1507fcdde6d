"""The port's per-design-point pipeline against the reference, stage by stage.

For NB, LCS and KM, a fresh reference ``trace_structural`` is bridged into
the port (``ColumnarTrace.from_arrays``) and both packages run every
fig14 geometry x fig15 CiM level set x fig16 technology on the CPU.  Each
stage must be identical: replay columns and counters, RUT/IHT and
``FlowIndex`` arrays, candidate tuples and claimed sets, ``ReshapedTrace``
fields, and every priced ``SystemReport`` field (``==`` on floats: the
port prices in the reference's float64 order).
"""
import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.core import accel as ref_accel
from repro.core.cache import CacheConfig as RefCacheConfig
from repro.core.idg import build_flow_index as ref_flow
from repro.core.offload import OffloadConfig as RefOffloadConfig
from repro.core.offload import select_candidates as ref_select
from repro.core.profiler import profile_system as ref_profile
from repro.core.reshape import reshape as ref_reshape
from repro.core.trace import attach_cache_results as ref_attach
from repro.core.trace import trace_structural
from repro.workloads import build

from repro_torch.core import (OffloadConfig, StructuralTrace,
                              attach_cache_results_batch, build_flow_index,
                              profile_system, reshape, select_candidates)
from repro_torch.core.columnar import ColumnarTrace
from repro_torch.workloads import fixtures

WORKLOADS = ("NB", "LCS", "KM")


@functools.lru_cache(maxsize=None)
def reference_trace(name):
    fn, args = build(name)
    return trace_structural(fn, *args)


def bridge(ref_st) -> StructuralTrace:
    """The reference's structural trace as a port trace on the CPU."""
    return StructuralTrace(
        ColumnarTrace.from_arrays(ref_st.columns.to_arrays(), device="cpu"),
        [torch.from_numpy(np.asarray(o)) for o in ref_st.outputs])


def cand_tuple(c):
    return (c.root_seq, tuple(c.op_seqs), tuple(c.op_classes),
            tuple(c.load_seqs), tuple(c.store_seqs), c.level, c.bank,
            c.moves, c.internal_edges, c.added_loads, c.memval_leaves,
            c.dram_fills)


def report_fields(rep):
    """Every field of a SystemReport, floats included, for == comparison."""
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
           if f.name not in ("base", "cim")}
    for side in ("base", "cim"):
        out[side] = dataclasses.asdict(getattr(rep, side))
    for prop in ("energy_improvement", "speedup", "processor_ratio",
                 "cache_ratio"):
        out[prop] = getattr(rep, prop)
    out["summary"] = rep.summary()
    return out


@pytest.mark.parametrize("name", WORKLOADS)
def test_structural_tables_match_reference(name):
    ref_st = reference_trace(name)
    ct = bridge(ref_st).columns
    ref_ct = ref_st.columns
    assert ct.rut == ref_ct.rut
    assert ct.iht == ref_ct.iht
    want = ref_flow(ref_ct).to_arrays()
    got = build_flow_index(ct).to_arrays()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("cache", list(fixtures.CACHES))
@pytest.mark.parametrize("name", WORKLOADS)
def test_design_points_match_reference(name, cache):
    ref_st = reference_trace(name)
    port_st = bridge(ref_st)
    geo = fixtures.CACHES[cache]
    with ref_accel.use_backend("numpy"):
        ref_tr = ref_attach(ref_st, tuple(
            RefCacheConfig(**dataclasses.asdict(c)) for c in geo))
    (tr,) = attach_cache_results_batch(port_st, [geo], device="cpu")

    # replay: columns and counters
    for col in ("level", "hit", "bank", "mshr"):
        got = getattr(tr.trace, col).numpy()
        want = getattr(ref_tr.trace, col)
        assert got.dtype == want.dtype and np.array_equal(got, want), col
    assert tr.cache.counters() == ref_tr.cache.counters()

    for lv_name, levels in fixtures.LEVEL_SETS.items():
        ref_cfg = RefOffloadConfig(cim_levels=levels)
        cfg = OffloadConfig(cim_levels=levels)
        with ref_accel.use_backend("numpy"):
            ref_res = ref_select(ref_tr.trace, cfg=ref_cfg)
        res = select_candidates(tr.trace, cfg=cfg, device="cpu")
        assert [cand_tuple(c) for c in res.candidates] == \
            [cand_tuple(c) for c in ref_res.candidates], lv_name
        assert res.claimed == ref_res.claimed

        ref_shaped = ref_reshape(ref_tr.trace, ref_res)
        shaped = reshape(tr.trace, res)
        assert shaped.host_seqs.tolist() == ref_shaped.host_seqs
        assert [(g.level, g.op_classes) for g in shaped.cim_groups] == \
            [(g.level, g.op_classes) for g in ref_shaped.cim_groups]
        for f in ("moves", "internal_moves", "added_loads", "dram_fills",
                  "n_offloaded", "n_cim_ops"):
            assert getattr(shaped, f) == getattr(ref_shaped, f), f

        for tech in fixtures.TECHS:
            want = report_fields(ref_profile(ref_tr, ref_cfg, tech,
                                             offload=ref_res,
                                             reshaped=ref_shaped))
            # once through the precomputed artifacts, once end to end
            assert report_fields(profile_system(
                tr, cfg, tech, offload=res, reshaped=shaped,
                device="cpu")) == want, (lv_name, tech)
            assert report_fields(profile_system(
                tr, cfg, tech, device="cpu")) == want, (lv_name, tech)
