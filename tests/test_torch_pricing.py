"""Pricing from one count call a point, against the path it replaced.

``profile_system`` takes every count a columnar design point is priced
from out of one ``price_counts`` call (one launch and one readback on the
card; on the CPU its plain version).  These tests hold its reports, field
for field and with the floats compared ``==``, to the present path: the
counts made by the op chain of bincounts, gathers and readbacks that
pricing ran before the count kernel, fed to the same host arithmetic, with
MACR from ``OffloadResult.macr_breakdown``.  They also hold the
per-selection index: built once for the points that share a selection,
and dropped with the selection.
"""
import dataclasses
import gc

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch.core import profiler
from repro_torch.core.cache import L1_32K, L2_256K
from repro_torch.core.host_model import HOST_PRESETS
from repro_torch.core.isa import LEVEL_L1, OP_STORE, UNITS
from repro_torch.core.offload import OffloadConfig, analyze_trace
from repro_torch.core.profiler import (PriceCounts, Profiler, SystemReport,
                                       profile_system)
from repro_torch.core.reshape import reshape
from repro_torch.core.trace import attach_cache_results
from repro_torch.dse import DSEEngine, SweepSpace
from repro_torch.workloads import fixtures

TECHS = ("sram", "fefet")


def _present_counts(trace, result, reshaped) -> PriceCounts:
    """The counts as the profiler made them before the count kernel."""
    def unit_counts(unit_col):
        return torch.bincount(unit_col.to(torch.int64),
                              minlength=len(UNITS)).tolist()

    def mem_counts(level_col, is_store_col):
        mem = level_col > 0
        combo = level_col[mem].to(torch.int64) * 2 \
            + is_store_col[mem].to(torch.int64)
        counts = torch.bincount(combo).tolist()
        return {(c // 2, c % 2): n for c, n in enumerate(counts) if n}

    hs = reshaped.host_seqs
    seqs = [s for c in result.candidates for s in c.load_seqs + c.store_seqs]
    l1 = int((trace.level[torch.tensor(seqs, dtype=torch.int64)]
              == LEVEL_L1).sum()) if seqs else 0
    return PriceCounts(
        units=unit_counts(trace.unit),
        mem=mem_counts(trace.level, trace.op == OP_STORE),
        host_units=unit_counts(trace.unit[hs]),
        host_mem=mem_counts(trace.level[hs], trace.op[hs] == OP_STORE),
        mem_accesses=trace.mem_accesses(), converted=len(seqs),
        converted_l1=l1)


def _present_report(tr, result, reshaped, tech, host) -> SystemReport:
    """``profile_system`` as it priced a columnar point before the count
    kernel: the op chain's counts, ``OffloadResult.macr_breakdown``."""
    trace = tr.trace
    prof = Profiler(tuple(lv.cfg for lv in tr.cache.levels), tech=tech,
                    host=host)
    counts = _present_counts(trace, result, reshaped)
    base_eb, base_cycles = prof.price_baseline(trace, counts)
    cim_eb, cim_cycles = prof.price_cim(trace, reshaped, counts)
    mb = result.macr_breakdown(trace)
    return SystemReport(
        base=base_eb, cim=cim_eb, base_cycles=base_cycles,
        cim_cycles=cim_cycles, macr=mb["macr"], macr_l1=mb["l1"],
        macr_other=mb["other"], n_instructions=len(trace),
        n_mem_accesses=int(mb["total_accesses"]),
        n_candidates=len(result.candidates),
        n_cim_ops=reshaped.n_cim_ops, n_offloaded=reshaped.n_offloaded,
        tech=tech)


@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_reports_equal_the_present_path(name):
    """The 17 programs at 32K+256K x 2 technologies x 4 host presets: every
    field of every report ``==``, floats and dicts included."""
    tr = attach_cache_results(fixtures.load_structural(name, device="cpu"),
                              (L1_32K, L2_256K), device="cpu")
    result = analyze_trace(tr).select(OffloadConfig())
    reshaped = reshape(tr.trace, result)
    for tech in TECHS:
        for host in HOST_PRESETS.values():
            got = profile_system(tr, tech=tech, host=host, offload=result,
                                 reshaped=reshaped, device="cpu")
            want = _present_report(tr, result, reshaped, tech, host)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (name, tech, host.name)
            assert got.base.cache == want.base.cache
            assert got.cim.cim == want.cim.cim


def test_profile_system_without_a_selection_prices_as_before():
    """No ``offload``/``reshaped`` passed: the selection and reshape are
    made inside, and priced as the present path prices them."""
    tr = attach_cache_results(fixtures.load_structural("KM", device="cpu"),
                              (L1_32K, L2_256K), device="cpu")
    cfg = OffloadConfig(cim_levels=("L1",))
    got = profile_system(tr, cfg, tech="fefet", device="cpu")
    result = analyze_trace(tr).select(cfg)
    want = _present_report(tr, result, reshape(tr.trace, result), "fefet",
                           HOST_PRESETS["A9-1GHz"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_direct_baseline_and_cim_pricing_count_for_themselves():
    """``price_baseline`` / ``price_cim`` called without counts (as
    ``bench/table5_validation.py`` calls the first) count on their own."""
    tr = attach_cache_results(fixtures.load_structural("NB", device="cpu"),
                              (L1_32K, L2_256K), device="cpu")
    result = analyze_trace(tr).select(OffloadConfig())
    reshaped = reshape(tr.trace, result)
    prof = Profiler((L1_32K, L2_256K), tech="sram")
    counts = _present_counts(tr.trace, result, reshaped)
    assert prof.price_baseline(tr.trace) == \
        prof.price_baseline(tr.trace, counts)
    assert prof.price_cim(tr.trace, reshaped) == \
        prof.price_cim(tr.trace, reshaped, counts)


def test_selection_index_is_built_once_for_points_that_share_it(
        monkeypatch):
    """Eight (technology, host) points of one selection: one converted-
    access index, built at the first of them."""
    built = []
    real = profiler._converted_index

    def counting(result, device):
        built.append(id(result))
        return real(result, device)

    monkeypatch.setattr(profiler, "_converted_index", counting)
    space = SweepSpace(workloads=("KM",), techs=TECHS,
                       hosts=tuple(HOST_PRESETS))
    assert len(space) == 8
    engine = DSEEngine(executor="serial", device="cpu")
    records = engine.run(space)
    assert engine.analysis.offload_builds == 1
    assert len(built) == 1
    # the same points again: the index lives as long as the selection
    engine.run(space)
    assert len(built) == 1
    want = DSEEngine(executor="serial", device="cpu").run(space)
    assert [r.to_dict() for r in records] == [r.to_dict() for r in want]
    assert len(built) == 2


def test_selection_index_leaves_with_the_selection():
    tr = attach_cache_results(fixtures.load_structural("NB", device="cpu"),
                              (L1_32K, L2_256K), device="cpu")
    result = analyze_trace(tr).select(OffloadConfig())
    reshaped = reshape(tr.trace, result)
    hs, conv = profiler._selection_index(result, reshaped, tr.trace.device)
    again = profiler._selection_index(result, reshaped, tr.trace.device)
    assert again[0] is hs and again[1] is conv
    assert torch.equal(hs, reshaped.host_seqs)
    assert conv.tolist() == [s for c in result.candidates
                             for s in c.load_seqs + c.store_seqs]
    key = (id(result), id(reshaped), tr.trace.device)
    assert key in profiler._index
    del result
    gc.collect()
    assert key not in profiler._index


def test_macr_breakdown_from_counts_matches_the_selection():
    tr = attach_cache_results(fixtures.load_structural("BFS", device="cpu"),
                              (L1_32K, L2_256K), device="cpu")
    for levels in (("L1",), ("L2",), ("L1", "L2")):
        result = analyze_trace(tr).select(OffloadConfig(cim_levels=levels))
        reshaped = reshape(tr.trace, result)
        counts = profiler.count_trace(
            tr.trace, *profiler._selection_index(result, reshaped,
                                                 tr.trace.device))
        assert counts.macr_breakdown() == result.macr_breakdown(tr.trace)
