"""repro_torch.dse's accelerator-mode backend against repro.dse (twin of
``tests/test_backends.py``).

The port's ``TpuBackend`` records each arch's reduced train step as an
ATen graph, where the reference traces a jaxpr; the two graphs differ (the
reference's walk sees only the jaxpr's top level, ROADMAP Queue 3), so
layer 1 is held to the reference on toy graphs (``test_torch_hlo.py``).
Everything above layer 1 is a pure function of the analysis, so fed the
reference's own analyses (``src/repro_torch/dse/fixtures/
reference_tpu_dse.json``) the port's selection and pricing must give the
reference's records and Pareto fronts, field for field.  The space's
``tpus`` axis, ``TpuOption``, ``parse_bytes``, ``tpu_neighbors``,
``arch_fingerprint`` and the ``tpu_model`` functions are held ``==``.

Regenerate the fixture (needs jax, ~15 s)::

    PYTHONPATH=src python tests/test_torch_backends.py --regenerate
"""
import dataclasses
import json
import pickle
import sys

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro import dse as ref
from repro.core import tpu_model as ref_tpu_model
from repro.dse import backends as ref_backends

from repro_torch import dse as port
from repro_torch.bench import fig_tpu_dse
from repro_torch.core import tpu_model
from repro_torch.dse import fixtures as tpu_fixtures
from repro_torch.dse.backends import (TpuCandidate, TpuSelection,
                                      TpuWorkloadAnalysis)
from repro_torch.dse.service import DSEService

ARCHS2 = tpu_fixtures.ARCHS2
KB = 1 << 10
OBJECTIVES = ("energy_improvement", "speedup")


@pytest.fixture(scope="module")
def tpu_engine():
    return port.DSEEngine(backend=port.TpuBackend(), device="cpu")


def _opt_dict(opt):
    return None if opt is None else dataclasses.asdict(opt)


def _norm_key(x):
    """A point key of either package as plain values (options, chips and
    cache geometries as their field dicts)."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (tuple, list)):
        return tuple(_norm_key(v) for v in x)
    return x


# --------------------------------------------------------------- options
def test_tpu_option_of_and_labels():
    opt = port.TpuOption.of("v5e")
    assert opt.chip == port.TPU_PRESETS["v5e"]
    assert opt.name == "v5e/thr64K"
    assert port.TpuOption.of(opt) is opt
    assert port.TpuOption.of(port.TPU_PRESETS["v4"]).chip_label == "v4"
    with pytest.raises(KeyError):
        port.TpuOption.of("v99")
    scaled = port.TpuOption(port.TPU_PRESETS["v5e"], 1 << 20, vmem_scale=0.5,
                            hbm_bw_scale=2.0)
    assert scaled.threshold_label == "thr1M"
    assert "vmem0.5" in scaled.chip_label and "bw2" in scaled.chip_label
    chip = scaled.effective_chip()
    assert chip.vmem_bytes == port.TPU_PRESETS["v5e"].vmem_bytes * 0.5
    assert chip.hbm_bw == port.TPU_PRESETS["v5e"].hbm_bw * 2.0
    # unscaled options hand back the preset object itself
    assert port.TpuOption.of("v5p").effective_chip() is \
        port.TPU_PRESETS["v5p"]


@pytest.mark.parametrize("chip,thr,vmem,bw", [
    ("v5e", 1 << 16, 1.0, 1.0), ("v4", 12345, 1.0, 1.0),
    ("v5p", 1 << 20, 0.5, 2.0), ("v5e", 3 * KB, 1e-9, 0.25)])
def test_tpu_option_equals_reference(chip, thr, vmem, bw):
    mine = port.TpuOption(port.TPU_PRESETS[chip], thr, vmem, bw)
    want = ref.TpuOption(ref.TPU_PRESETS[chip], thr, vmem, bw)
    assert (mine.chip_label, mine.threshold_label, mine.name) == \
        (want.chip_label, want.threshold_label, want.name)
    assert dataclasses.asdict(mine.effective_chip()) == \
        dataclasses.asdict(want.effective_chip())


def test_parse_bytes():
    assert port.parse_bytes("16K") == 1 << 14
    assert port.parse_bytes("1M") == 1 << 20
    assert port.parse_bytes("4096") == 4096
    assert port.parse_bytes(512) == 512
    for spec in ("16K", "1m", " 64k ", "256K", "2M", "4096", 7, "0"):
        assert port.parse_bytes(spec) == ref.parse_bytes(spec)
    for bad in ("K", "1.5M", "lots"):
        with pytest.raises(ValueError):
            port.parse_bytes(bad)
        with pytest.raises(ValueError):
            ref.parse_bytes(bad)


def test_tpu_presets_frozen_hashable():
    assert len({hash(c) for c in port.TPU_PRESETS.values()}) == 3
    with pytest.raises(dataclasses.FrozenInstanceError):
        port.TPU_PRESETS["v4"].hbm_bw = 1.0
    # capability-ordered declaration (the adjacency contract)
    peaks = [c.peak_flops_bf16 for c in port.TPU_PRESETS.values()]
    assert peaks == sorted(peaks)
    # the reference's design points, carried over as data
    assert {k: dataclasses.asdict(v) for k, v in port.TPU_PRESETS.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref.TPU_PRESETS.items()}
    assert list(port.TPU_PRESETS) == list(ref.TPU_PRESETS)
    assert dataclasses.asdict(tpu_model.TpuChip()) == \
        dataclasses.asdict(ref_tpu_model.TpuChip())


# ------------------------------------------------------------ enumeration
def test_space_tpu_axis_enumeration():
    tpus = (port.TpuOption.of("v5e"),
            port.TpuOption(port.TPU_PRESETS["v4"], 32 * KB))
    space = port.SweepSpace(workloads=ARCHS2, tpus=tpus)
    pts = space.points()
    assert len(pts) == len(space) == 4
    # TPU axis iterates innermost and never splits the per-workload
    # analysis chunk (one graph analysis per workload)
    assert [p.tpu.chip_label for p in pts[:2]] == ["v5e", "v4"]
    assert len({p.analysis_key for p in pts}) == 2
    assert pts[0].analysis_key == ("qwen1.5-0.5b", "tpu")
    # TPU points hash (dedup backbone) and carry the option in key/label
    assert len({hash(p) for p in pts}) == 4
    assert len({p.key for p in pts}) == 4
    assert pts[1].label == "qwen1.5-0.5b/v4/thr32K"
    # CiM spaces are untouched by the new axis default
    cim = port.SweepSpace(workloads=("KM",))
    assert cim.points()[0].tpu is None
    assert len(cim.points()[0].key) == 6


@pytest.mark.parametrize("chips,thresholds", [
    (("v5e", "v4", "v5p"), (16 * KB, 64 * KB, 256 * KB)),
    (("v5p", "v5e"), (1 << 20, 8 * KB))])
def test_tpu_space_equals_reference(chips, thresholds):
    """Labels, keys, analysis keys and neighborhoods of a TPU space, point
    for point, as the reference enumerates them."""
    def build(pkg):
        return pkg.SweepSpace(workloads=ARCHS2, tpus=tuple(
            pkg.TpuOption(pkg.TPU_PRESETS[c], t)
            for c in chips for t in thresholds))
    ps, rs = build(port), build(ref)
    assert len(ps) == len(rs)
    for pp, rp in zip(ps.points(), rs.points()):
        assert (pp.index, pp.label, pp.analysis_key) == \
            (rp.index, rp.label, rp.analysis_key)
        assert _norm_key(pp.key) == _norm_key(rp.key)
        assert [m.label for m in port.neighborhood(pp, ps)] == \
            [m.label for m in ref.neighborhood(rp, rs)]
        assert [_opt_dict(t) for t in port.tpu_neighbors(pp.tpu, ps.tpus)] \
            == [_opt_dict(t) for t in ref.tpu_neighbors(rp.tpu, rs.tpus)]
    assert [p.label for p in port.coarse_seed(ps)] == \
        [p.label for p in ref.coarse_seed(rs)]


# -------------------------------------------------------------- selection
def _analysis(candidates):
    return TpuWorkloadAnalysis(
        workload="w", batch=2, seq_len=32, flops=1e9,
        total_bytes=sum(c.saved_bytes for c in candidates) * 2 or 1,
        collective_bytes=0.0, hlo_bytes=0.0, n_eqns=9,
        candidates=tuple(candidates))


def test_selection_threshold_and_vmem_fit():
    small = TpuCandidate(n_ops=2, input_bytes=4 * KB, output_bytes=4 * KB,
                         saved_bytes=8 * KB)
    big = TpuCandidate(n_ops=5, input_bytes=64 * KB, output_bytes=64 * KB,
                       saved_bytes=512 * KB)
    an = _analysis([small, big])
    # threshold filters the small chain out
    sel = port.TpuBackend._select(an, min_saved_bytes=64 * KB,
                                  vmem_bytes=1e9)
    assert (sel.n_accepted, sel.saved_bytes) == (1, 512 * KB)
    # zero threshold accepts both
    sel = port.TpuBackend._select(an, min_saved_bytes=0, vmem_bytes=1e9)
    assert sel.n_accepted == 2 and sel.accepted_ops == 7
    # a VMEM too small for the big chain's working set rejects it even
    # though it clears the threshold (workset = in + out + saved/2)
    assert big.workset_bytes == (64 + 64 + 256) * KB
    sel = port.TpuBackend._select(an, min_saved_bytes=0,
                                  vmem_bytes=big.workset_bytes - 1)
    assert sel.n_accepted == 1 and sel.saved_bytes == small.saved_bytes


# ------------------------------------------------------------- end-to-end
def test_tpu_sweep_end_to_end(tpu_engine):
    results = tpu_engine.run(tpu_fixtures.end_to_end_space())
    assert len(results) == 8
    st = results.stats
    # one graph analysis per workload; one fusion selection per
    # (workload, threshold) — chips share both layers (pricing-only)
    assert st["trace_builds"] == 2
    assert st["offload_builds"] == 4
    for r in results:
        assert r.backend == "tpu"
        assert r.tech == "tpu" and r.cim_levels == "VMEM"
        assert 0.0 <= r.macr <= 1.0
        assert r.speedup >= 1.0 and r.energy_improvement >= 1.0
        assert r.base_energy_pj > r.cim_energy_pj or r.macr == 0.0
        assert r.n_candidates > 0
    # fusion aggressiveness is monotone: a higher threshold never saves
    # more traffic than a lower one (same workload, same chip)
    by = {(r.workload, r.cache, r.cim_set): r for r in results}
    for w in ARCHS2:
        for chip in ("v5e", "v4"):
            assert (by[(w, chip, "thr16K")].macr
                    >= by[(w, chip, "thr256K")].macr)
    # re-running does zero analysis work (per-run counter deltas)
    again = tpu_engine.run(tpu_fixtures.end_to_end_space())
    assert again.stats["trace_builds"] == 0
    assert again.stats["offload_builds"] == 0
    assert [r.energy_improvement for r in again] == \
        [r.energy_improvement for r in results]


def test_vmem_scale_gates_selection(tpu_engine):
    """A VMEM scaled to nothing rejects every candidate: the point prices
    as the unfused baseline (macr 0, improvement exactly 1.0)."""
    opt = port.TpuOption(port.TPU_PRESETS["v5e"], 16 * KB, vmem_scale=1e-9)
    space = port.SweepSpace(workloads=(ARCHS2[1],), tpus=(opt,))
    (rec,) = tpu_engine.run(space).records
    assert rec.macr == 0.0
    assert rec.energy_improvement == 1.0 and rec.speedup == 1.0


def test_tpu_records_report_and_pareto(tpu_engine):
    tpus = [port.TpuOption(port.TPU_PRESETS["v5e"], t)
            for t in (16 * KB, 256 * KB)]
    results = tpu_engine.run(port.SweepSpace(workloads=(ARCHS2[0],),
                                             tpus=tpus))
    md = results.to_markdown(columns=("workload", "cache", "cim_set",
                                      "energy_improvement", "speedup"))
    assert "thr16K" in md and "Pareto frontier" in md
    front = results.pareto(OBJECTIVES)
    assert front and all(r.backend == "tpu" for r in front)


def test_one_analysis_per_workload_and_none_on_a_warm_store(tmp_path):
    space = port.SweepSpace(workloads=(ARCHS2[1],),
                            tpus=("v5e", "v4", "v5p"))
    cold = port.DSEEngine(backend=port.TpuBackend(), store=tmp_path,
                          device="cpu").run(space)
    assert cold.stats["trace_builds"] == 1
    assert cold.stats["store_writes"] == 1
    warm = port.DSEEngine(backend=port.TpuBackend(), store=tmp_path,
                          device="cpu").run(space)
    assert warm.stats["trace_builds"] == 0
    assert warm.stats["store_l1_hits"] == 1
    assert [r.to_dict() for r in warm] == [r.to_dict() for r in cold]
    # the artifact sits under the port's namespace
    assert all(f.name.startswith("cimtorch-")
               for f in (tmp_path / "layer1").iterdir())


# ------------------------------------------------------------- neighbors
def test_tpu_neighbors_single_knob_moves():
    chips = [port.TPU_PRESETS[c] for c in ("v5e", "v4", "v5p")]
    thrs = [16 * KB, 64 * KB, 256 * KB]
    grid = [port.TpuOption(c, t) for c in chips for t in thrs]
    mid = port.TpuOption(chips[1], thrs[1])
    nbs = port.tpu_neighbors(mid, grid)
    # exactly one knob per move: adjacent chips at the same threshold,
    # adjacent thresholds on the same chip
    assert {(n.chip.name, n.min_saved_bytes) for n in nbs} == {
        (chips[0].name, thrs[1]), (chips[2].name, thrs[1]),
        (chips[1].name, thrs[0]), (chips[1].name, thrs[2])}
    corner = port.TpuOption(chips[0], thrs[0])
    assert len(port.tpu_neighbors(corner, grid)) == 2
    # sparse universes stay sparse: undeclared combinations never appear
    sparse = [port.TpuOption(chips[0], thrs[0]),
              port.TpuOption(chips[1], thrs[1])]
    assert port.tpu_neighbors(port.TpuOption(chips[0], thrs[0]),
                              sparse) == []
    assert port.tpu_neighbors(None, grid) == []
    # ...and the full-point neighborhood emits them as tpu-axis moves
    space = port.SweepSpace(workloads=(ARCHS2[0],), tpus=tuple(grid))
    point = space.points()[4]                      # the mid option
    moves = port.neighborhood(point, space)
    assert {m.tpu for m in moves if m.tpu != point.tpu} == set(nbs)


# ------------------------------------------------- adaptive (acceptance)
def test_adaptive_tpu_matches_exhaustive_with_fewer_points(tpu_engine):
    """AdaptiveDSE over the TPU space reproduces the exhaustive
    per-workload Pareto frontier at fewer priced points."""
    tpus = [port.TpuOption(port.TPU_PRESETS[c], t)
            for c in ("v5e", "v4", "v5p")
            for t in (8 * KB, 32 * KB, 128 * KB, 512 * KB)]
    space = port.SweepSpace(workloads=ARCHS2, tpus=tpus)
    exhaustive = tpu_engine.run(space)
    adaptive = port.AdaptiveDSE(space, engine=tpu_engine).run()

    def ident(rec):
        return (rec.workload, rec.cache, rec.cim_set)

    assert ({ident(r) for r in adaptive.frontier}
            == {ident(r) for r in exhaustive.pareto()})
    assert adaptive.n_priced < len(space)
    assert adaptive.rounds[-1].stable or adaptive.n_priced == len(space)
    # refinement rounds reused the warmed analyses: zero builds anywhere
    assert all(r.stats.get("trace_builds", 0) == 0
               for r in adaptive.rounds)


# ---------------------------------------------------------------- protocol
def test_default_backend_is_cim():
    eng = port.DSEEngine(device="cpu")
    assert isinstance(eng.backend, port.CimBackend)
    (rec,) = eng.run(port.SweepSpace(workloads=("NB",))).records
    assert rec.backend == "cim"


def test_backends_pickle_roundtrip():
    """Backends ride to spawned process workers: they must pickle, and
    equal-by-value copies must behave identically."""
    for b in (port.CimBackend(), port.TpuBackend(),
              port.TpuBackend(batch=4, seq_len=16)):
        clone = pickle.loads(pickle.dumps(b))
        assert clone == b and clone.name == b.name
    opt = port.TpuOption(port.TPU_PRESETS["v5p"], 64 * KB, vmem_scale=0.25)
    assert pickle.loads(pickle.dumps(opt)) == opt
    sel = TpuSelection(1, 2, 3, 4, 5.0)
    assert pickle.loads(pickle.dumps(sel)) == sel


def test_backend_versions_and_warm_equal_reference():
    """``version`` stamps each backend's store entries: the protocol's is
    0, the CiM backend's the trace VM's, the TPU backend's its analysis
    version -- the reference's numbers, but for the TPU backend's, one
    ahead: the port's recorded step runs on weights drawn from a seed and
    can record a configuration at its published widths.  ``warm`` builds
    the layer-1 artifact of one point, as the reference's does."""
    from repro.dse.backends import AnalysisBackend as RefBase
    from repro_torch.dse.backends import AnalysisBackend
    assert AnalysisBackend.version.fget(None) == RefBase.version.fget(None) == 0
    assert port.CimBackend().version == ref.CimBackend().version == 2
    assert port.TpuBackend().version == ref.TpuBackend().version + 1 == 2
    from repro_torch.core.sampling import SamplingSpec
    assert port.CimBackend(sampling=SamplingSpec(
        mode="stratified")).version == 2
    assert callable(AnalysisBackend.warm) and callable(RefBase.warm)
    cache = port.AnalysisCache(device="cpu")
    (point,) = port.SweepSpace(workloads=("NB",)).points()
    port.CimBackend().warm(cache, point)
    assert cache.stats()["trace_builds"] == 1
    port.CimBackend().warm(cache, point)
    assert cache.stats()["trace_hits"] == 1


def test_core_exports_cover_the_reference():
    import repro.core as ref_core
    import repro_torch.core as port_core
    assert set(ref_core.__all__) <= set(port_core.__all__)
    for name in ref_core.__all__:
        assert getattr(port_core, name) is not None, name


# ------------------------------------------- the reference's analyses
def _ref_analysis(d):
    return ref_backends.TpuWorkloadAnalysis(**dict(
        d, candidates=tuple(ref_backends.TpuCandidate(**c)
                            for c in d["candidates"])))


@dataclasses.dataclass(frozen=True)
class _RefRecordedTpuBackend(ref.TpuBackend):
    """The reference's backend on the fixture's analyses (no jax)."""

    def _analyze(self, workload):
        return _ref_analysis(tpu_fixtures.load()["analyses"][workload])


def test_fixture_holds_the_reference_workloads():
    doc = tpu_fixtures.load()
    assert sorted(doc["analyses"]) == sorted(fig_tpu_dse.WORKLOADS)
    assert set(ARCHS2) <= set(doc["analyses"])
    assert len(doc["grid"]["records"]) == 36
    assert len(doc["end_to_end"]) == 8
    assert sorted(doc["fingerprints"]) == sorted(_archs())


def _archs():
    from repro_torch.configs.registry import ARCHS
    return list(ARCHS)


def test_layers_2_and_3_equal_reference_on_its_analyses():
    """fig_tpu_dse's grid priced by the port's ``_select`` and ``price`` on
    the reference's analyses: the 36 records and the Pareto front equal
    the fixture's and a live reference run on the same analyses, every
    field."""
    doc = tpu_fixtures.load()
    got = port.DSEEngine(backend=tpu_fixtures.RecordedTpuBackend(),
                         device="cpu").run(fig_tpu_dse.space())
    rspace = ref.SweepSpace(workloads=fig_tpu_dse.WORKLOADS, tpus=tuple(
        ref.TpuOption(ref.TpuOption.of(c).chip, ref.parse_bytes(t))
        for c in fig_tpu_dse.CHIPS for t in fig_tpu_dse.THRESHOLDS))
    want = ref.DSEEngine(backend=_RefRecordedTpuBackend()).run(rspace)
    mine = [r.to_dict() for r in got]
    assert mine == [r.to_dict() for r in want]
    assert mine == doc["grid"]["records"]
    front = [r.to_dict() for r in got.pareto(OBJECTIVES)]
    assert front == [r.to_dict() for r in want.pareto(OBJECTIVES)]
    assert front == doc["grid"]["pareto"]
    # the header's wall seconds are each run's own clock, not a result
    got.elapsed_s = want.elapsed_s
    assert got.to_markdown(pareto_objectives=OBJECTIVES) == \
        want.to_markdown(pareto_objectives=OBJECTIVES)


def test_end_to_end_records_equal_reference():
    doc = tpu_fixtures.load()
    got = port.DSEEngine(backend=tpu_fixtures.RecordedTpuBackend(),
                         device="cpu").run(tpu_fixtures.end_to_end_space())
    assert [r.to_dict() for r in got] == doc["end_to_end"]


@pytest.mark.parametrize("workload", ARCHS2)
def test_select_and_price_equal_reference(workload):
    """Each layer on its own, over every threshold/VMEM scale/bandwidth
    scale of a small grid, with the default option too."""
    d = tpu_fixtures.load()["analyses"][workload]
    mine, theirs = tpu_fixtures.analysis_from_dict(d), _ref_analysis(d)
    assert tpu_fixtures.analysis_dict(mine) == \
        tpu_fixtures.analysis_dict(theirs)
    index = 0
    for chip in ("v5e", "v4", "v5p"):
        for thr in (0, 4 * KB, 64 * KB, 1 << 20):
            for vmem, bw in ((1.0, 1.0), (1e-4, 1.0), (0.5, 3.0)):
                popt = port.TpuOption(port.TPU_PRESETS[chip], thr, vmem, bw)
                ropt = ref.TpuOption(ref.TPU_PRESETS[chip], thr, vmem, bw)
                vm = popt.effective_chip().vmem_bytes
                psel = port.TpuBackend._select(mine, thr, vm)
                rsel = ref.TpuBackend._select(theirs, thr, vm)
                assert dataclasses.asdict(psel) == dataclasses.asdict(rsel)
                for pt, rt in ((popt, ropt), (None, None)):
                    pp = port.SweepPoint(index, workload, port.CacheOption
                                         .of("32K+256K"), ("L1",), "sram",
                                         tpu=pt)
                    rp = ref.SweepPoint(index, workload, ref.CacheOption
                                        .of("32K+256K"), ("L1",), "sram",
                                        tpu=rt)
                    got = port.TpuBackend().price(pp, mine, psel, None)
                    want = ref.TpuBackend().price(rp, theirs, rsel, None)
                    assert got.to_dict() == want.to_dict()
                    index += 1


@pytest.mark.parametrize("args", [
    (197e12, 819e9, 50e9, 256), (197e12 * 3, 819e9, 0, 8),
    (0.0, 0.0, 0.0, 1), (1.5e9, 2.25e7, 3e5, 4), (-1.0, 7.0, -3.0, 2)])
def test_tpu_model_functions_equal_reference(args):
    for name in ("v5e", "v4", "v5p"):
        pc, rc = port.TPU_PRESETS[name], ref.TPU_PRESETS[name]
        mine = tpu_model.roofline_terms(*args, chip=pc)
        want = ref_tpu_model.roofline_terms(*args, chip=rc)
        assert dataclasses.asdict(mine) == dataclasses.asdict(want)
        assert mine.as_dict() == want.as_dict()
        assert (mine.dominant, mine.bound_s, mine.roofline_fraction) == \
            (want.dominant, want.bound_s, want.roofline_fraction)
        assert tpu_model.step_energy_pj(*args, chip=pc) == \
            ref_tpu_model.step_energy_pj(*args, chip=rc)
    assert tpu_model.roofline_terms(*args).as_dict() == \
        ref_tpu_model.roofline_terms(*args).as_dict()
    for kind in ("train", "serve"):
        assert tpu_model.model_flops(int(args[3]) * 1000, 37, kind) == \
            ref_tpu_model.model_flops(int(args[3]) * 1000, 37, kind)


def test_arch_fingerprint_equals_reference():
    doc = tpu_fixtures.load()
    for arch in _archs():
        assert port.arch_fingerprint(arch) == ref.arch_fingerprint(arch) \
            == doc["fingerprints"][arch]
    assert port.arch_fingerprint("no-such-arch") == \
        ref.arch_fingerprint("no-such-arch")


# ------------------------------------------------------------- service
def test_service_tpu_request_equals_the_engine():
    """One ``"backend": "tpu"`` request through the in-process service
    returns the engine's records (the wire form of ``to_dict``)."""
    doc = {"backend": "tpu", "workloads": [ARCHS2[1]],
           "tpus": ["v5e", {"chip": "v4", "min_saved_bytes": "16K"},
                    {"chip": "v5p", "min_saved_bytes": 1 << 20,
                     "vmem_scale": 0.5}]}
    svc = DSEService(device="cpu", tracing=False)
    events = list(svc.handle_query(doc))
    assert [e["event"] for e in events] == ["start", "result"]
    assert events[0]["backend"] == "tpu"
    space = port.SweepSpace(workloads=(ARCHS2[1],), tpus=(
        "v5e", port.TpuOption(port.TPU_PRESETS["v4"], 16 * KB),
        port.TpuOption(port.TPU_PRESETS["v5p"], 1 << 20, vmem_scale=0.5)))
    want = port.DSEEngine(backend=port.TpuBackend(), device="cpu").run(space)
    assert events[1]["records"] == [r.to_dict() for r in want]
    assert all(r["backend"] == "tpu" and r["tech"] == "tpu"
               for r in events[1]["records"])
    # a repeated request is answered from the record memo
    again = list(svc.handle_query(doc))
    assert again[1]["records"] == events[1]["records"]
    assert svc.analysis_cache("tpu").stats()["trace_builds"] == 1
    assert svc.analysis_cache("cim").stats()["trace_builds"] == 0


def test_record_train_step_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    from repro_torch.configs.registry import reduced_config
    from repro_torch.dse.backends import analyze_train_step
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_train_step(reduced_config(ARCHS2[0]), 2, 32, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.DSEEngine(backend=port.TpuBackend())


# ------------------------------------------------------------- fixture
def regenerate_doc() -> dict:
    """The fixture, as a fresh reference run computes it (needs jax)."""
    import jax
    from repro.configs.registry import ARCHS as REF_ARCHS

    eng = ref.DSEEngine(backend=ref.TpuBackend())
    rspace = ref.SweepSpace(workloads=fig_tpu_dse.WORKLOADS, tpus=tuple(
        ref.TpuOption(ref.TpuOption.of(c).chip, ref.parse_bytes(t))
        for c in fig_tpu_dse.CHIPS for t in fig_tpu_dse.THRESHOLDS))
    grid = eng.run(rspace)
    assert grid.stats["trace_builds"] == len(fig_tpu_dse.WORKLOADS)
    analyses = {w: eng.analysis._blobs[(1, "tpu", w, 2, 32)]
                for w in fig_tpu_dse.WORKLOADS}
    e2e_space = ref.SweepSpace(workloads=ARCHS2, tpus=tuple(
        ref.TpuOption(ref.TPU_PRESETS[c], t)
        for c in ("v5e", "v4") for t in (16 * KB, 256 * KB)))
    e2e = eng.run(e2e_space)
    assert e2e.stats["trace_builds"] == 0
    return json.loads(json.dumps({
        "jax_version": jax.__version__,
        "analyses": {w: dataclasses.asdict(a) for w, a in analyses.items()},
        "grid": {"records": [r.to_dict() for r in grid],
                 "pareto": [r.to_dict() for r in grid.pareto(OBJECTIVES)]},
        "end_to_end": [r.to_dict() for r in e2e],
        "fingerprints": {a: ref.arch_fingerprint(a)
                         for a in sorted(REF_ARCHS)},
    }))


def test_fixture_equals_fresh_reference():
    import jax
    committed = tpu_fixtures.load()
    if committed["jax_version"] != jax.__version__:
        pytest.skip(f"the fixture was written under jax "
                    f"{committed['jax_version']}; this is jax "
                    f"{jax.__version__}, which may trace the steps "
                    "differently")
    assert regenerate_doc() == committed


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_backends.py "
                 "--regenerate")
    tpu_fixtures.FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    tpu_fixtures.FIXTURE.write_text(
        json.dumps(regenerate_doc(), indent=1, sort_keys=True) + "\n")
    print(f"wrote {tpu_fixtures.FIXTURE}")
