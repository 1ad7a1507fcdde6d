"""repro_torch.core.sampling against repro.core.sampling (twin of
``tests/test_sampling.py``, without its service-codec cases).

The port's own cases mirror the reference file: spec codecs and
validation, plan construction, the estimator, the windowed machinery's
byte-identity against the exact VM, warmup interleaving, exact-record
``to_dict`` and the backend's exact and sampled records.  The differential
cases give both packages the same workloads and specs and compare with
``==``: the skim's features and stream length, the plan, every windowed
column, the marks, the estimates, and the engine's sweep records and
counters.

``src/repro_torch/workloads/fixtures/reference_sampled.json`` is the
card's oracle (the card's machine may have no jax); this file writes it::

    PYTHONPATH=src python tests/test_torch_sampling.py --regenerate
"""
import dataclasses
import json
import sys
from unittest import mock

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro import dse as ref_dse
from repro.core import sampling as ref
from repro.core.cache import CacheConfig as RefCacheConfig
from repro.core.offload import OffloadConfig as RefOffloadConfig

from repro_torch import dse as port_dse
from repro_torch.bench.sampling import SYNTH_SPEC
from repro_torch.core import sampling as port
from repro_torch.core.cache import L1_32K, L2_256K
from repro_torch.core.columnar import COLUMNS
from repro_torch.core.offload import OffloadConfig, analyze_trace
from repro_torch.core.profiler import profile_system
from repro_torch.core.reshape import reshape
from repro_torch.core.sampling.estimate import COMPONENTS
from repro_torch.core.sampling.machines import SkimResult
from repro_torch.core.trace import (StructuralTrace, TraceInterpreter,
                                    TraceLimits, attach_cache_results,
                                    attach_cache_results_batch,
                                    trace_structural)
from repro_torch.dse.results import SweepRecord
from repro_torch.workloads import fixtures

LEVELS = (L1_32K, L2_256K)
REF_LEVELS = tuple(RefCacheConfig(**dataclasses.asdict(c)) for c in LEVELS)
LIMITS = TraceLimits(max_instructions=1 << 62)
WL = "hmmer"                     # smallest/fastest registry kernel
MODES = ("stratified", "phase")
#: small enough to really sample the scaled workloads below
SMALL = dict(interval=256, budget=4, warmup=256, seed=1)
DIFF_WORKLOADS = ("KM@4", "KM@16", "NB@8", "BFS")


def _exact_report(workload):
    fn, args = port.build_workload(workload)
    st_ = trace_structural(fn, *args, limits=LIMITS, device="cpu")
    tr = attach_cache_results(st_, LEVELS, device="cpu")
    analysis = analyze_trace(tr)
    result = analysis.select(OffloadConfig())
    return profile_system(tr, offload=result,
                          reshaped=reshape(analysis.trace, result),
                          device="cpu")


def _est_dict(est):
    return (est.totals, est.metrics, est.ci, est.n_windows, est.n_intervals)


# ----------------------------------------------------------------- spec
def test_spec_key_parse_dict_roundtrip():
    spec = port.SamplingSpec(mode="phase", interval=1024, budget=16, seed=3,
                             warmup=4096, target_ci=0.05, n_boot=50)
    assert spec.key() == "phase:i1024:b16:s3:w4096:t0.05:r50"
    assert port.SamplingSpec.parse(
        "phase:interval=1024,budget=16,seed=3,warmup=4096,"
        "target_ci=0.05,n_boot=50") == spec
    assert port.SamplingSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == ref.SamplingSpec(**spec.to_dict()).to_dict()
    assert port.SamplingSpec().key() == "exact"
    assert port.SamplingSpec.parse("exact") == port.SamplingSpec()
    assert port.SamplingSpec(mode="stratified").key() == \
        "stratified:i2048:b32:s0"
    assert port.SAMPLING_VERSION == ref.SAMPLING_VERSION
    assert port.__all__ == ref.__all__


@pytest.mark.parametrize("bad", [
    dict(mode="simpoint"), dict(interval=32), dict(budget=0),
    dict(warmup=-1), dict(target_ci=1.0), dict(confidence=0.3),
    dict(n_boot=5)])
def test_spec_validation(bad):
    with pytest.raises(ValueError):
        port.SamplingSpec(**{"mode": "stratified", **bad})


def test_spec_parse_rejects_unknown_knob():
    with pytest.raises(ValueError):
        port.SamplingSpec.parse("phase:windows=4")
    with pytest.raises(ValueError):
        port.SamplingSpec.from_dict({"mode": "phase", "windows": 4})


# ----------------------------------------------------------------- plans
def _fake_skim(n_int, interval=64, rng=None, cls=SkimResult):
    rng = rng or np.random.default_rng(0)
    feats = rng.uniform(0.0, 5.0, size=(n_int, 6))
    return cls(features=feats, total_virtual=n_int * interval,
               interval=interval)


def test_plan_full_coverage_degenerates():
    plan = port.build_plan(_fake_skim(8),
                           port.SamplingSpec(mode="stratified", budget=32))
    assert plan.full and plan.n_windows == 1
    assert plan.windows() == [(0, 8 * 64)]
    assert plan.weights().tolist() == [1.0]


@pytest.mark.parametrize("mode", MODES)
def test_plan_weights_expand_to_population(mode):
    """Sum of expansion weights == interval count, picks are unique and
    sorted, every cluster is represented -- and every plan is the
    reference's."""
    for seed in range(4):
        spec = port.SamplingSpec(mode=mode, budget=8, seed=seed)
        plan = port.build_plan(_fake_skim(40), spec)
        assert not plan.full
        assert plan.n_windows == 8
        assert plan.weights().sum() == pytest.approx(plan.n_intervals)
        idx = [p for p, _ in plan.picks]
        assert idx == sorted(idx) and len(set(idx)) == len(idx)
        assert {c for _, c in plan.picks} == set(np.unique(plan.cluster_of))
        want = ref.build_plan(
            _fake_skim(40, cls=ref.SkimResult),
            ref.SamplingSpec(**spec.to_dict()))
        assert plan.picks == want.picks
        assert np.array_equal(plan.cluster_of, want.cluster_of)
        assert plan.weights().tolist() == want.weights().tolist()


# ------------------------------------------------------------- estimator
def test_estimator_identity_when_every_interval_sampled():
    """Weights of 1 over a full enumeration: totals are exact sums."""
    rng = np.random.default_rng(1)
    n = 12
    Y = rng.uniform(1.0, 2.0, size=(n, len(COMPONENTS)))
    plan = port.SamplePlan(interval=64, total_virtual=n * 64,
                           mode="stratified", cluster_of=np.arange(n),
                           picks=tuple((i, i) for i in range(n)))
    est = port.estimate(Y, plan, port.SamplingSpec(mode="stratified",
                                                   n_boot=10))
    np.testing.assert_allclose(
        [est.totals[c] for c in COMPONENTS], Y.sum(0), rtol=1e-12)
    assert est.ci["energy_improvement"] == 0.0   # singletons: no variance


@pytest.mark.parametrize("n_int,budget", [(16, 4), (23, 4), (37, 4),
                                          (30, 7), (48, 10)])
def test_estimator_over_seeds_equals_reference(n_int, budget):
    """The stratified expansion estimator over 48 seeds, as the
    reference's unbiasedness property draws it: every seed's plan and
    estimate (totals, metrics, CIs) is the reference's ``==``, so the
    seed-averaged totals are too."""
    rng = np.random.default_rng(n_int * 101 + budget)
    Y = rng.uniform(1.0, 2.0, size=(n_int, len(COMPONENTS)))
    acc_port = np.zeros(len(COMPONENTS))
    acc_ref = np.zeros(len(COMPONENTS))
    for seed in range(48):
        kw = dict(mode="stratified", budget=budget, seed=seed, n_boot=10)
        spec = port.SamplingSpec(**kw)
        plan = port.build_plan(
            _fake_skim(n_int, rng=np.random.default_rng(7)), spec)
        est = port.estimate(Y[[p for p, _ in plan.picks]], plan, spec)
        rspec = ref.SamplingSpec(**kw)
        rplan = ref.build_plan(_fake_skim(
            n_int, rng=np.random.default_rng(7), cls=ref.SkimResult), rspec)
        rest = ref.estimate(Y[[p for p, _ in rplan.picks]], rplan, rspec)
        assert plan.picks == rplan.picks
        assert _est_dict(est) == _est_dict(rest)
        acc_port += [est.totals[c] for c in COMPONENTS]
        acc_ref += [rest.totals[c] for c in COMPONENTS]
    assert acc_port.tolist() == acc_ref.tolist()


def test_estimator_rejects_shape_mismatch():
    plan = port.build_plan(_fake_skim(40),
                           port.SamplingSpec(mode="stratified", budget=8))
    with pytest.raises(ValueError):
        port.estimate(np.ones((3, len(COMPONENTS))), plan,
                      port.SamplingSpec(mode="stratified"))


# ----------------------------------------------- windowed-trace machinery
@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_full_window_trace_is_byte_identical(name):
    """One window covering the whole virtual stream must emit exactly the
    exact VM's rows — the foundation of exact-mode byte-identity."""
    fn, args = port.build_workload(name)
    st_ = trace_structural(fn, *args, limits=LIMITS, device="cpu")
    skim = port.skim_program(fn, *args, interval=2048)
    wt = port.trace_windows(fn, *args, windows=[(0, skim.total_virtual)],
                            limits=LIMITS, expect_total=skim.total_virtual,
                            device="cpu")
    assert wt.marks == [(0, 0, st_.columns.n)]
    a, b = st_.columns.to_arrays(), wt.structural.columns.to_arrays()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(st_.outputs, wt.structural.outputs):
        assert torch.equal(x, y)


def test_drifted_count_formula_fails_loudly():
    """A handler whose emission loop walks a different number of virtual
    slots than its formula predicts raises instead of mis-placing the
    windows."""
    fn, args = port.build_workload("KM@4")
    orig = TraceInterpreter._elementwise

    def one_more(self, op, invals, out_data):
        out = orig(self, op, invals, out_data)
        self.m.emit_branch()
        return out

    with mock.patch.object(TraceInterpreter, "_elementwise", one_more):
        with pytest.raises(AssertionError, match="span drift"):
            port.trace_windows(fn, *args, windows=[(0, 1 << 40)],
                               limits=LIMITS, device="cpu")


def test_degenerate_plan_reproduces_exact_metrics():
    """budget >= n_intervals: the sampled pipeline is the identity."""
    rep = _exact_report(WL)
    est = port.sampled_report(WL, port.SamplingSpec(mode="stratified"),
                              LEVELS, OffloadConfig(), device="cpu")
    assert est.n_windows == 1
    assert est.metrics["energy_improvement"] == pytest.approx(
        rep.energy_improvement, rel=1e-12)
    assert est.metrics["macr"] == pytest.approx(rep.macr, rel=1e-12)
    assert est.metrics["speedup"] == pytest.approx(rep.speedup, rel=1e-12)
    assert est.ci["energy_improvement"] == 0.0


def test_sampled_structural_interleaves_warmup():
    """Genuine sampling: warmup prefixes are traced but only measured
    windows are priced, and measured_marks() indexes the right rows."""
    spec = port.SamplingSpec(mode="stratified", interval=256, budget=4,
                             warmup=256, seed=1)
    ss = port.sampled_structural(WL, spec)
    assert not ss.plan.full and len(ss.plan.picks) == 4
    assert len(ss.measured) == 4 and len(ss.marks) > 4
    measured = ss.measured_marks()
    assert [m[0] for m in measured] == sorted(m[0] for m in measured)
    rep = _exact_report(WL)
    est = port.sampled_report(WL, spec, LEVELS, OffloadConfig(),
                              device="cpu")
    assert est.n_windows == 4
    assert est.metrics["energy_improvement"] == pytest.approx(
        rep.energy_improvement, rel=0.35)
    assert est.ci["energy_improvement"] >= 0.0
    want = ref.sampled_structural(WL, ref.SamplingSpec(**spec.to_dict()))
    assert (ss.marks, ss.measured) == (want.marks, want.measured)


def test_sampled_structural_no_warmup_marks_all_measured():
    spec = port.SamplingSpec(mode="stratified", interval=256, budget=4,
                             warmup=0, seed=1)
    ss = port.sampled_structural(WL, spec)
    assert ss.measured == () and len(ss.marks) == 4
    assert ss.measured_marks() == ss.marks


# ------------------------------------------------- differential: pipeline
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("workload", DIFF_WORKLOADS)
def test_sampled_pipeline_equals_reference(workload, mode):
    """Skim, plan, windowed columns, marks and the estimate, ``==``."""
    pspec = port.SamplingSpec(mode=mode, **SMALL)
    rspec = ref.SamplingSpec(mode=mode, **SMALL)
    fn, args = port.build_workload(workload)
    rfn, rargs = ref.build_workload(workload)
    skim = port.skim_program(fn, *args, interval=pspec.interval)
    rskim = ref.skim_program(rfn, *rargs, interval=rspec.interval)
    assert skim.total_virtual == rskim.total_virtual
    assert skim.features.tolist() == rskim.features.tolist()

    ss = port.sampled_structural(workload, pspec)
    rss = ref.sampled_structural(workload, rspec)
    assert not ss.plan.full
    assert ss.plan.picks == rss.plan.picks
    assert ss.plan.cluster_of.tolist() == rss.plan.cluster_of.tolist()
    assert ss.plan.weights().tolist() == rss.plan.weights().tolist()
    assert (ss.marks, ss.measured) == (rss.marks, rss.measured)
    assert ss.columns.keys() == rss.columns.keys()
    for k, a in rss.columns.items():
        assert ss.columns[k].dtype == a.dtype, k
        assert np.array_equal(ss.columns[k], a), k

    sa = port.attach_sampled(ss, LEVELS, device="cpu")
    est = port.price_sampled(sa, port.select_sampled(sa, OffloadConfig()),
                             pspec)
    rsa = ref.attach_sampled(rss, REF_LEVELS)
    rest = ref.price_sampled(rsa, ref.select_sampled(rsa,
                                                     RefOffloadConfig()),
                             rspec)
    assert _est_dict(est) == _est_dict(rest)
    assert sa.cache.counters() == rsa.cache.counters()


def test_attach_sampled_slices_the_replayed_stream():
    """Each measured window is the replayed full stream's rows, with the
    source CSR re-based."""
    ss = port.sampled_structural("KM@4", port.SamplingSpec(
        mode="stratified", **SMALL))
    sa = port.attach_sampled(ss, LEVELS, device="cpu")
    (full,) = attach_cache_results_batch(
        StructuralTrace(ss.trace("cpu"), []), [LEVELS], device="cpu")
    assert len(sa.windows) == len(ss.measured)
    for tr, (_, lo, hi) in zip(sa.windows, ss.measured_marks()):
        ct = tr.trace
        assert ct.n == hi - lo
        assert torch.equal(ct.level, full.trace.level[lo:hi])
        assert torch.equal(ct.hit, full.trace.hit[lo:hi])
        assert int(ct.src_off[0]) == 0
        assert int(ct.src_off[-1]) == len(ct.src_val)


# -------------------------------------------------------- records/backend
def _record(**over):
    base = dict(index=0, workload=WL, cache="32K+256K", cim_levels="L1+L2",
                tech="sram", cim_set="stt", host="A9-1GHz",
                energy_improvement=1.5, speedup=1.1, macr=0.4, macr_l1=0.3,
                base_energy_pj=10.0, cim_energy_pj=6.7, base_cycles=100.0,
                cim_cycles=90.0, base_runtime_ms=0.1, cim_runtime_ms=0.09,
                processor_ratio=0.5, cache_ratio=0.5, n_instructions=1000,
                n_mem_accesses=200, n_candidates=50, n_cim_ops=10)
    base.update(over)
    return SweepRecord(**base)


def test_sweep_record_to_dict_drops_sampling_when_exact():
    rec = _record()
    doc = rec.to_dict()
    assert "sampling" not in doc and "energy_improvement_ci" not in doc
    sampled = dataclasses.replace(rec, sampling="stratified:i64:b4:s0",
                                  energy_improvement_ci=0.01)
    doc = sampled.to_dict()
    assert doc["sampling"] == "stratified:i64:b4:s0"
    assert doc["energy_improvement_ci"] == 0.01
    assert doc == ref_dse.SweepRecord(**dataclasses.asdict(sampled)
                                      ).to_dict()


def test_backend_exact_spec_is_byte_identical_to_default():
    """SamplingSpec(mode='exact') through the engine: records equal the
    default backend's field for field, with no sampling columns."""
    space = port_dse.SweepSpace(workloads=(WL,), techs=("sram", "fefet"))
    base = port_dse.DSEEngine(executor="serial", device="cpu"
                              ).run(space).records
    exact = port_dse.DSEEngine(
        executor="serial", device="cpu",
        backend=port_dse.CimBackend(sampling=port.SamplingSpec())
    ).run(space).records
    assert [r.to_dict() for r in base] == [r.to_dict() for r in exact]
    assert all(r.sampling == "exact" for r in exact)
    assert port_dse.CimBackend().variant is None


def test_backend_sampled_records_carry_key_and_ci():
    spec = port.SamplingSpec(mode="stratified", interval=256, budget=4,
                             warmup=256, seed=1)
    backend = port_dse.CimBackend(sampling=spec)
    assert backend.variant == spec.key()
    eng = port_dse.DSEEngine(executor="serial", device="cpu",
                             backend=backend)
    (rec,) = eng.run(port_dse.SweepSpace(workloads=(WL,))).records
    assert rec.sampling == spec.key()
    doc = rec.to_dict()
    assert {"sampling", "energy_improvement_ci", "speedup_ci",
            "macr_ci"} <= doc.keys()
    assert rec.energy_improvement > 0 and rec.energy_improvement_ci >= 0
    # warm repeat prices from the memoized sampled artifacts
    (rec2,) = eng.run(port_dse.SweepSpace(workloads=(WL,))).records
    assert rec2.to_dict() == doc


def _engines(spec_kw, executor="serial", **port_kw):
    return (ref_dse.DSEEngine(executor=executor, backend=ref_dse.CimBackend(
                sampling=ref.SamplingSpec(**spec_kw))),
            port_dse.DSEEngine(executor=executor, device="cpu",
                               backend=port_dse.CimBackend(
                                   sampling=port.SamplingSpec(**spec_kw)),
                               **port_kw))


@pytest.mark.parametrize("executor", ["serial", "thread"])
@pytest.mark.parametrize("mode", MODES)
def test_engine_sampled_records_equal_reference(mode, executor):
    """A sampled sweep over two workloads, two geometries and two
    technologies: records (sampling key and CI columns included) and
    counters are the reference's."""
    kw = dict(workloads=("KM@4", WL), caches=("32K+256K", "64K+2M"),
              techs=("sram", "fefet"))
    r_eng, p_eng = _engines(dict(mode=mode, **SMALL), executor)
    r = r_eng.run(ref_dse.SweepSpace(**kw))
    p = p_eng.run(port_dse.SweepSpace(**kw))
    assert [x.to_dict() for x in p.records] == \
        [x.to_dict() for x in r.records]
    assert all(x.sampling == port.SamplingSpec(mode=mode, **SMALL).key()
               for x in p.records)
    assert p.stats == r.stats


def test_target_ci_refinement_equals_reference():
    """CI-driven refinement doubles the budget until the energy CI meets
    the target (at most three times): the refined records and the
    counters of every refined spec's builds are the reference's."""
    spec = dict(mode="stratified", interval=256, budget=2, warmup=256,
                seed=3, target_ci=1e-6)
    r_eng, p_eng = _engines(spec)
    r = r_eng.run(ref_dse.SweepSpace(workloads=("KM@16",)))
    p = p_eng.run(port_dse.SweepSpace(workloads=("KM@16",)))
    assert [x.to_dict() for x in p.records] == \
        [x.to_dict() for x in r.records]
    # three doublings: 2 -> 4 -> 8 -> 16 windows, each its own identity
    assert p.records[0].sampling == port.SamplingSpec(
        **{**spec, "budget": 16}).key()
    assert p.stats == r.stats and p.stats["trace_builds"] == 8


def test_warm_store_skips_the_sampled_trace(tmp_path):
    """A second engine on a warm store loads the skim/plan/windowed
    artifact instead of running the program: no trace pass, no store
    write, records equal.  As in the reference, the per-geometry replay is
    memo-only, so each geometry still counts one layer-1 build."""
    kw = dict(workloads=(WL, "KM@4"), techs=("sram", "fefet"))
    spec = port.SamplingSpec(mode="phase", **SMALL)
    cold = port_dse.DSEEngine(executor="serial", device="cpu", store=tmp_path,
                              backend=port_dse.CimBackend(sampling=spec)
                              ).run(port_dse.SweepSpace(**kw))
    with mock.patch.object(port.pipeline, "sampled_structural",
                           side_effect=AssertionError("traced again")):
        warm = port_dse.DSEEngine(
            executor="serial", device="cpu", store=tmp_path,
            backend=port_dse.CimBackend(sampling=spec)
        ).run(port_dse.SweepSpace(**kw))
    assert [r.to_dict() for r in warm] == [r.to_dict() for r in cold]
    assert warm.stats["store_l1_hits"] == 2
    assert warm.stats["store_writes"] == 0
    assert warm.stats["trace_builds"] == 2       # the memo-only replays
    assert cold.stats["trace_builds"] == 4
    assert warm.stats["store_bytes_cimtorch"] == \
        warm.stats["store_bytes_total"]
    r_cold = ref_dse.DSEEngine(
        executor="serial", store=tmp_path / "ref",
        backend=ref_dse.CimBackend(sampling=ref.SamplingSpec(
            **spec.to_dict()))).run(ref_dse.SweepSpace(**kw))
    r_warm = ref_dse.DSEEngine(
        executor="serial", store=tmp_path / "ref",
        backend=ref_dse.CimBackend(sampling=ref.SamplingSpec(
            **spec.to_dict()))).run(ref_dse.SweepSpace(**kw))
    assert [r.to_dict() for r in warm] == [r.to_dict() for r in r_warm]
    for k in ("trace_builds", "trace_hits", "offload_builds",
              "store_l1_hits", "store_writes"):
        assert warm.stats[k] == r_warm.stats[k], k
        assert cold.stats[k] == r_cold.stats[k], k


# ------------------------------------------------------- committed oracle
def test_committed_oracle_matches_port_on_the_suite():
    """The fixture's suite records (the reference's, default spec) are
    what the port's sampled engine writes, for three workloads (their
    positions in this smaller space aside)."""
    want = fixtures.reference_sampled()["suite"]
    names = ("NB", "DFS", "hmmer")

    def unindexed(rec):
        return {k: v for k, v in rec.items() if k != "index"}

    for mode in MODES:
        p = port_dse.DSEEngine(
            executor="serial", device="cpu",
            backend=port_dse.CimBackend(sampling=port.SamplingSpec(
                mode=mode))).run(port_dse.SweepSpace(
                    workloads=names, techs=tuple(want["techs"])))
        got = [unindexed(r.to_dict()) for r in p.records]
        assert got == [unindexed(r) for r in want["records"][mode]
                       if r["workload"] in names]


def test_committed_oracle_shape():
    doc = fixtures.reference_sampled()
    assert doc["meta"]["sampling_version"] == port.SAMPLING_VERSION
    syn = doc["synthetic"]
    assert syn["workload"] == "KM@256" and syn["spec"] == SYNTH_SPEC
    for mode in MODES:
        s = syn["modes"][mode]
        assert len(s["plan"]["picks"]) == SYNTH_SPEC["budget"]
        assert s["plan"]["total_virtual"] >= 1_000_000
        assert len(s["measured"]) == SYNTH_SPEC["budget"]
        assert sorted(s["columns"]) == sorted(
            [f"col_{c}" for c in COLUMNS] + ["meta_n_regs"])
        assert len(doc["suite"]["records"][mode]) == \
            len(fixtures.WORKLOADS) * len(doc["suite"]["techs"])


# ======================================================================
# --regenerate: the card's oracle
# ======================================================================
def regenerate():
    import jax
    from repro.core.trace import TRACE_VM_VERSION
    techs = ("sram", "fefet")
    doc = {"meta": {"jax_version": jax.__version__,
                    "trace_vm_version": TRACE_VM_VERSION,
                    "sampling_version": ref.SAMPLING_VERSION,
                    "cache": "32K+256K"},
           "synthetic": {"workload": "KM@256", "spec": dict(SYNTH_SPEC),
                         "modes": {}},
           "suite": {"techs": list(techs), "records": {}}}
    for mode in MODES:
        # through the engine, as a user sweeps it; the engine's memoized
        # artifacts then give the plan, the windows and the estimate
        spec = ref.SamplingSpec(mode=mode, **SYNTH_SPEC)
        backend = ref_dse.CimBackend(sampling=spec)
        eng = ref_dse.DSEEngine(executor="serial", backend=backend)
        space = ref_dse.SweepSpace(workloads=("KM@256",))
        (rec,) = eng.run(space).records
        (point,) = space.points()
        sa = backend.analyze(eng.analysis, point)
        est = ref.price_sampled(sa, backend.select(eng.analysis, point, sa),
                                spec)
        summary = fixtures.sampled_summary(sa.structural, est)
        summary["record"] = rec.to_dict()
        doc["synthetic"]["modes"][mode] = summary
        print(f"KM@256 {mode}: {summary['rows']} rows, "
              f"{len(summary['marks'])} marks, metrics {est.metrics}")
        eng = ref_dse.DSEEngine(executor="serial", backend=ref_dse.CimBackend(
            sampling=ref.SamplingSpec(mode=mode)))
        res = eng.run(ref_dse.SweepSpace(workloads=fixtures.WORKLOADS,
                                         techs=techs))
        doc["suite"]["records"][mode] = [r.to_dict() for r in res.records]
    fixtures.SAMPLED_PATH.write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_sampling.py "
                 "--regenerate")
    regenerate()
