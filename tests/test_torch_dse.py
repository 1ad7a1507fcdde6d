"""repro_torch.dse against repro.dse (twin of ``tests/test_dse.py``).

The same sweep spaces go through both packages on the committed traces:
enumeration, labels and keys must be equal; every record's ``to_dict()``
and the engine's ``stats()`` must be equal with ``==`` (the reference run
under ``EVA_CIM_ACCEL=jax``, whose warm path batches the replay per
workload as the port's always does); the reports (Pareto fronts,
``to_json``, ``to_markdown``) must be the same bytes.
"""
import contextlib
import dataclasses
import threading
from unittest import mock

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.core.cache import CacheConfig as RefCacheConfig
from repro.core.host_model import HOST_PRESETS as REF_HOSTS
from repro.core.host_model import HostModel as RefHostModel
from repro import dse as ref

from repro_torch import dse as port
from repro_torch import kernels
from repro_torch.core import accel
from repro_torch.core.cache import CacheConfig
from repro_torch.core.host_model import HostModel
from repro_torch.workloads import fixtures

CACHES = ("32K+256K", "64K+256K", "64K+2M")


@contextlib.contextmanager
def reference_on_fixtures():
    """The reference engine reads each workload's structural trace from
    the committed fixture -- the port's input -- instead of tracing it
    anew, so the two packages price the same trace whatever jax lowers
    today (``tests/test_torch_fixtures.py`` holds the fixtures to fresh
    traces)."""
    from repro.core.columnar import ColumnarTrace
    from repro.core.trace import StructuralTrace
    from repro.dse.engine import AnalysisCache

    def structural(self, workload):
        with self._lock:
            st = self._structural.get(workload)
            if st is None:
                a = fixtures.load_arrays(workload)
                st = self._structural[workload] = StructuralTrace(
                    ColumnarTrace.from_arrays(a),
                    [a[f"out_{i}"]
                     for i in range(int(a["meta_n_outputs"][0]))])
            return st

    with mock.patch.object(AnalysisCache, "_structural_trace", structural):
        yield
LEVELS = ("L1_only", "L2_only", "both")


def norm(x):
    """A value of either package as plain tuples, so equal designs of the
    two packages compare equal."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple(norm(getattr(x, f.name)) for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return tuple(sorted((k, norm(v)) for k, v in x.items()))
    if isinstance(x, (frozenset, set)):
        return ("set", tuple(sorted(x)))
    if isinstance(x, (tuple, list)):
        return tuple(norm(v) for v in x)
    return x


def ref_key(point):
    """A reference CiM point's key in the port's form: the reference
    appends the point's ``tpu`` option, ``None`` on every CiM point."""
    assert point.tpu is None
    return point.key[:-1]


def both(**axes):
    """The same space in each package; ``custom`` values are built per
    package from their field dicts."""
    def build(pkg, cache_cls, host_cls):
        kw = dict(axes)
        kw["caches"] = tuple(
            tuple(cache_cls(**c) for c in v) if isinstance(v, list) else v
            for v in axes.get("caches", ("32K+256K",)))
        kw["hosts"] = tuple(host_cls(**h) if isinstance(h, dict) else h
                            for h in axes.get("hosts", (None,)))
        return pkg.SweepSpace(**kw)
    return (build(ref, RefCacheConfig, RefHostModel),
            build(port, CacheConfig, HostModel))


SPACES = {
    "fig-axes": dict(workloads=("KM", "NB"), caches=CACHES,
                     cim_levels=LEVELS, techs=("sram", "fefet")),
    "custom-geometry-and-host": dict(
        workloads=("NB",),
        caches=("32K+256K",
                [dict(name="L1", size=32 * 1024, assoc=8),
                 dict(name="L2", size=256 * 1024, assoc=8)],
                [dict(name="L1", size=128 * 1024, assoc=4),
                 dict(name="L2", size=2 << 20, assoc=8)]),
        cim_levels=("both", ("L2",)), cim_sets=("stt", "logic", "full"),
        hosts=(None, "inorder-1GHz",
               dict(pipeline_pj=99.0, name="A9-1GHz"))),
    "sets-techs-and-default-host": dict(
        workloads=("LCS", "BFS"), cim_levels=(("L1",), "L2_only"),
        techs=("fefet", "sram"), cim_sets=("full", "logic", "stt"),
        hosts=("big-OoO-2GHz", None)),
}


@pytest.mark.parametrize("name", SPACES)
def test_enumeration_labels_and_keys_equal_reference(name):
    rs, ps = both(**SPACES[name])
    assert len(rs) == len(ps) and rs.n_analyses() == ps.n_analyses()
    rp, pp = rs.points(), ps.points()
    assert [p.label for p in pp] == [p.label for p in rp]
    assert [p.index for p in pp] == [p.index for p in rp]
    assert [norm(p.key) for p in pp] == [norm(ref_key(p)) for p in rp]
    assert [norm(p.analysis_key) for p in pp] == \
        [norm(p.analysis_key) for p in rp]
    assert [norm(p.offload_config()) for p in pp] == \
        [norm(p.offload_config()) for p in rp]
    assert [c.name for c in ps.caches] == [c.name for c in rs.caches]


def test_presets_and_parsers_equal_reference():
    assert {k: norm(v) for k, v in port.CACHE_PRESETS.items()} == \
        {k: norm(v) for k, v in ref.CACHE_PRESETS.items()}
    assert port.LEVEL_PRESETS == ref.LEVEL_PRESETS
    assert {k: sorted(v) for k, v in port.CIM_SETS.items()} == \
        {k: sorted(v) for k, v in ref.CIM_SETS.items()}
    assert norm(port.HOST_PRESETS) == norm(REF_HOSTS)
    for levels in ((dict(name="L1", size=128 * 1024, assoc=4),
                    dict(name="L2", size=2 << 20, assoc=8)),
                   (dict(name="SPM", size=1 << 20, assoc=16),)):
        assert port.CacheOption.of(tuple(CacheConfig(**c)
                                         for c in levels)).name == \
            ref.CacheOption.of(tuple(RefCacheConfig(**c)
                                     for c in levels)).name
    custom = HostModel(pipeline_pj=1.0)
    assert port.HostOption.of(custom).name == \
        ref.HostOption.of(RefHostModel(pipeline_pj=1.0)).name


def test_space_rejects_unknown_names():
    for bad in (dict(caches=("1G+2G",)), dict(techs=("memristor",)),
                dict(cim_sets=("everything",)), dict(cim_levels=("L9",))):
        with pytest.raises(KeyError):
            port.SweepSpace(workloads=("KM",), **bad).points()


# ------------------------------------------------------------ the engine
SWEEP = dict(workloads=("NB", "LiR", "KM"), caches=CACHES,
             cim_levels=LEVELS, techs=("sram", "fefet"),
             hosts=("A9-1GHz", "inorder-1GHz"))
_REF_RUNS = {}


def ref_run(executor, monkeypatch):
    """The reference's sweep under EVA_CIM_ACCEL=jax (memoized per
    executor)."""
    if executor not in _REF_RUNS:
        monkeypatch.setenv("EVA_CIM_ACCEL", "jax")
        with reference_on_fixtures():
            _REF_RUNS[executor] = ref.DSEEngine(executor=executor).run(
                ref.SweepSpace(**SWEEP))
    return _REF_RUNS[executor]


@pytest.mark.parametrize("executor", ["thread", "serial"])
def test_records_and_stats_equal_reference(executor, monkeypatch):
    want = ref_run(executor, monkeypatch)
    got = port.DSEEngine(executor=executor, device="cpu").run(
        port.SweepSpace(**SWEEP))
    assert len(got) == len(want) == 108
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert got.stats == want.stats
    if executor == "thread":
        # one batched replay per workload, one selection per (cache, level);
        # each point and each selection reads its trace from the memo
        assert got.stats == {"trace_builds": 9, "trace_hits": 117,
                             "offload_builds": 27, "offload_hits": 81,
                             "replay_batches": 3}


def test_process_executor_equals_thread_records(tmp_path, monkeypatch):
    want = ref_run("thread", monkeypatch)
    eng = port.DSEEngine(executor="process", max_workers=2,
                         store=tmp_path, device="cpu")
    space = port.SweepSpace(workloads=("NB", "LiR"), caches=CACHES[:2],
                            cim_levels=LEVELS, techs=("sram", "fefet"),
                            hosts=("A9-1GHz", "inorder-1GHz"))
    got = eng.run(space)
    by_label = {(r.workload, r.cache, r.cim_levels, r.tech, r.host):
                r.to_dict() for r in want}
    for r in got:
        d = r.to_dict()
        assert d == {**by_label[(r.workload, r.cache, r.cim_levels,
                                 r.tech, r.host)], "index": r.index}
    assert [r.index for r in got] == list(range(len(space)))
    assert got.stats["trace_builds"] == space.n_analyses() == 4
    assert got.stats["offload_builds"] == 12
    # CPU workers run the plain versions: no kernel launch to report
    assert eng.worker_launches == {"replay": 0, "place": 0,
                                   "price_counts": 0}
    again = port.DSEEngine(executor="process", max_workers=2,
                           store=tmp_path, device="cpu").run(space)
    assert again.stats["trace_builds"] == again.stats["offload_builds"] == 0
    assert [r.to_dict() for r in again] == [r.to_dict() for r in got]


def test_reports_are_the_reference_bytes(monkeypatch):
    want = ref_run("thread", monkeypatch)
    got = port.DSEEngine(device="cpu").run(port.SweepSpace(**SWEEP))
    got.elapsed_s = want.elapsed_s
    assert got.to_json() == want.to_json()
    assert got.to_markdown() == want.to_markdown()
    objectives = ("energy_improvement", ("cim_energy_pj", "min"))
    assert got.to_markdown(pareto_objectives=objectives) == \
        want.to_markdown(pareto_objectives=objectives)
    for per_workload in (True, False):
        assert [r.to_dict() for r in got.pareto(per_workload=per_workload)] \
            == [r.to_dict() for r in want.pareto(per_workload=per_workload)]
    for metric in ("energy_improvement", "speedup", "macr"):
        assert got.best(metric, workload="KM").to_dict() == \
            want.best(metric, workload="KM").to_dict()
    assert [r.config_label for r in got] == [r.config_label for r in want]
    merged, ref_merged = got.merge(got), want.merge(want)
    assert [r.to_dict() for r in merged] == \
        [r.to_dict() for r in ref_merged]
    assert merged.stats == ref_merged.stats


def test_pareto_front_equals_reference_on_hand_built_rows():
    nan, inf = float("nan"), float("inf")
    rows = [{"a": 1.0, "b": 5.0}, {"a": 2.0, "b": 4.0}, {"a": 2.0, "b": 4.0},
            {"a": 0.5, "b": 0.5}, {"a": nan, "b": 9.0}, {"a": inf, "b": 1.0},
            {"a": 3.0, "b": 1.0}, {"a": 1.5, "b": 4.5}]
    for objectives in (("a", "b"), (("a", "min"), "b"), ("a",),
                       (("b", "min"),)):
        assert port.pareto_front(rows, objectives) == \
            ref.pareto_front(rows, objectives)
        assert [port.objective_vector(r, objectives) for r in rows[:4]] == \
            [ref.objective_vector(r, objectives) for r in rows[:4]]
    assert port.dominates((2, 2), (1, 2)) and not port.dominates((1, 2),
                                                                 (1, 2))
    assert port.frontier_stable(rows[:2], rows[1::-1], ("a", "b")) == \
        ref.frontier_stable(rows[:2], rows[1::-1], ("a", "b")) is True
    with pytest.raises(ValueError):
        port.pareto_front(rows, (("a", "up"),))


def test_tpu_and_sampled_sweeps_are_refused_not_priced_as_cim():
    """A TPU point is priced by the TPU backend alone: the CiM backend
    refuses it, whether its workload is an arch or a Table-IV program, and
    records nothing.  The sampling knob is priced by the sampled pipeline:
    the port's records have the reference's fields, sampling key and CI
    columns included, in the reference's order and with its defaults."""
    for workload in ("NB", "xlstm-125m"):
        space = port.SweepSpace(workloads=(workload,), tpus=("v5e",))
        assert [p.tpu is not None for p in space] == [True]
        for executor in ("thread", "serial"):
            eng = port.DSEEngine(device="cpu", executor=executor)
            with pytest.raises(ValueError, match="TpuBackend"):
                eng.run(space)
            assert eng.analysis.stats()["trace_builds"] == 0
    assert [(f.name, f.default) for f in dataclasses.fields(
        port.SweepRecord)] == [(f.name, f.default) for f in
                               dataclasses.fields(ref.SweepRecord)]
    assert port.SweepRecord._SAMPLING_KEYS == ref.SweepRecord._SAMPLING_KEYS


def test_engine_rejects_bad_arguments(tmp_path):
    with pytest.raises(ValueError, match="executor"):
        port.DSEEngine(executor="fiber", device="cpu")
    with pytest.raises(ValueError, match="either cache= or store="):
        port.DSEEngine(cache=port.AnalysisCache(device="cpu"),
                       store=tmp_path, device="cpu")


def test_engine_builds_on_its_device():
    eng = port.DSEEngine(device="cpu")
    assert eng.device == eng.analysis.device == torch.device("cpu")
    eng.run(port.SweepSpace(workloads=("NB",), caches=CACHES[:2]))
    for tr in eng.analysis._traces.values():
        assert tr.trace.device == torch.device("cpu")
    # the two geometries replayed in one batched call
    assert eng.analysis.replay_batches == 1
    assert eng.analysis.single_replays == 0


@pytest.mark.parametrize("package", [accel, kernels])
def test_launch_counts_are_exact_under_threads(package):
    """8 threads x 1,000 launches each: every count is kept."""
    name = package.KERNELS[0]
    package.reset_launch_counts()
    threads = [threading.Thread(
        target=lambda: [package.count_launch(name) for _ in range(1000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    counts = package.launch_counts()
    package.reset_launch_counts()
    assert counts[name] == 8000
    assert all(v == 0 for k, v in counts.items() if k != name)
