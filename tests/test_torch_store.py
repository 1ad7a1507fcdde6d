"""repro_torch.dse.store against repro.dse.store (twin of
``tests/test_store.py``): warm runs build nothing, damaged artifacts are
dropped and rebuilt, a newer directory format refuses to open, the two
packages share a directory without ever serving each other's artifacts,
and the layer-1 encoding round-trips to the reference's arrays."""
import json
import pickle

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.core.offload import analyze_trace as ref_analyze
from repro.dse import DSEEngine as RefEngine
from repro.dse import SweepSpace as RefSpace

from repro_torch.core.offload import (OffloadConfig, analyze_trace,
                                      rehydrate_analysis)
from repro_torch.core.idg import FlowIndex
from repro_torch.core.reshape import reshape
from repro_torch.dse import (AnalysisCache, AnalysisStore, DSEEngine,
                             StoreFormatError, SweepSpace,
                             workload_fingerprint)
from repro_torch.dse.space import CacheOption
from repro_torch.dse.store import NAMESPACE, STORE_FORMAT
from repro_torch.workloads import fixtures
from test_torch_dse import reference_on_fixtures

CACHE = CacheOption.of("32K+256K")
AXES = dict(workloads=("NB", "LiR"), caches=("32K+256K", "64K+2M"),
            cim_levels=("L1_only", "both"), techs=("sram", "fefet"))


def sweep(store, **kw):
    return DSEEngine(store=store, device="cpu", **kw).run(SweepSpace(**AXES))


def dicts(results):
    return [r.to_dict() for r in results]


@pytest.fixture(scope="module")
def fresh():
    """The sweep with no store at all."""
    return DSEEngine(device="cpu").run(SweepSpace(**AXES))


def test_warm_store_means_no_builds_in_a_new_engine(tmp_path, fresh):
    cold = sweep(tmp_path)
    assert cold.stats["trace_builds"] == 4 and cold.stats["replay_batches"] \
        == 2
    assert cold.stats["store_writes"] > 0
    warm = sweep(tmp_path)
    assert warm.stats["trace_builds"] == 0
    assert warm.stats["offload_builds"] == 0
    assert warm.stats["replay_batches"] == 0
    assert warm.stats["store_l1_hits"] == 4
    assert warm.stats["store_l2_hits"] == 8
    assert dicts(cold) == dicts(warm) == dicts(fresh)


def test_keys_are_content_addressed(tmp_path):
    store = AnalysisStore(tmp_path)
    k1 = store.layer1_key("NB", CACHE.levels)
    assert k1 == store.layer1_key("NB", CACHE.levels)
    assert k1 != store.layer1_key("KM", CACHE.levels)
    assert k1 != store.layer1_key("NB", CacheOption.of("64K+256K").levels)
    k2 = store.layer2_key("NB", CACHE.levels, OffloadConfig())
    assert k2 != k1 != AnalysisStore(tmp_path, version=99).layer1_key(
        "NB", CACHE.levels)
    assert k2 != store.layer2_key("NB", CACHE.levels,
                                  OffloadConfig(cim_levels=("L1",)))
    # a workload's fingerprint is its program's source
    assert workload_fingerprint("NB") != workload_fingerprint("KM")
    assert workload_fingerprint("NB") == workload_fingerprint("NB")


@pytest.mark.parametrize("layer", [1, 2])
def test_damaged_artifact_is_dropped_and_rebuilt(tmp_path, fresh, layer):
    sweep(tmp_path)
    victims = sorted(p for p in (tmp_path / f"layer{layer}").iterdir()
                     if p.name.startswith(NAMESPACE) and ".flow-" not in
                     p.name)                  # a trace or a selection
    assert victims
    victims[0].write_bytes(b"not an artifact")
    again = sweep(tmp_path)
    assert again.stats["store_corrupt_drops"] == 1
    assert again.stats["trace_builds" if layer == 1 else
                       "offload_builds"] == 1
    assert dicts(again) == dicts(fresh)
    # the rebuild repaired it: a third engine builds nothing
    third = sweep(tmp_path)
    assert third.stats["trace_builds"] == third.stats["offload_builds"] == 0
    assert third.stats["store_corrupt_drops"] == 0


def test_foreign_payload_under_a_key_is_rejected(tmp_path, fresh):
    sweep(tmp_path)
    a, b = sorted((tmp_path / "layer2").glob(f"{NAMESPACE}-*"))[:2]
    b.write_bytes(a.read_bytes())             # right format, wrong key
    again = sweep(tmp_path)
    assert again.stats["store_corrupt_drops"] == 1
    assert again.stats["offload_builds"] == 1
    assert dicts(again) == dicts(fresh)


def test_newer_format_directory_refuses_to_open(tmp_path):
    AnalysisStore(tmp_path)
    marker = tmp_path / "FORMAT.json"
    assert json.loads(marker.read_text()) == {"store_format": STORE_FORMAT}
    marker.write_text(json.dumps({"store_format": STORE_FORMAT + 1}))
    with pytest.raises(StoreFormatError):
        AnalysisStore(tmp_path)
    with pytest.raises(StoreFormatError):
        DSEEngine(store=tmp_path, device="cpu")
    marker.write_text("{broken")               # unreadable: restamped
    AnalysisStore(tmp_path)
    assert json.loads(marker.read_text()) == {"store_format": STORE_FORMAT}


def test_one_directory_never_serves_one_package_to_the_other(tmp_path,
                                                             fresh):
    with reference_on_fixtures():
        ref_cold = RefEngine(store=tmp_path).run(RefSpace(**AXES))
    assert ref_cold.stats["trace_builds"] == 4
    port_run = sweep(tmp_path)                 # a warm reference store...
    assert port_run.stats["trace_builds"] == 4     # ...is no help to it
    assert port_run.stats["store_l1_hits"] == 0
    assert port_run.stats["store_l2_hits"] == 0
    assert port_run.stats["store_corrupt_drops"] == 0
    with reference_on_fixtures():
        ref_warm = RefEngine(store=tmp_path).run(RefSpace(**AXES))
    assert ref_warm.stats["trace_builds"] == 0     # its own artifacts only
    assert ref_warm.stats["store_l1_hits"] == 4
    assert ref_warm.stats["store_corrupt_drops"] == 0
    assert dicts(port_run) == dicts(fresh) == dicts(ref_warm)
    names = [p.name for p in tmp_path.glob("layer*/*")]
    assert {n.split("-", 1)[0] for n in names} == {"cim", NAMESPACE}
    usage = port_run.stats
    assert usage["store_bytes_cimtorch"] > 0 and usage["store_bytes_cim"] > 0
    assert usage["store_bytes_total"] == \
        usage["store_bytes_layer1"] + usage["store_bytes_layer2"]


def test_layer1_round_trip_equals_the_reference_arrays(tmp_path):
    from repro.core.cache import L1_32K as R_L1, L2_256K as R_L2
    from repro.core.columnar import ColumnarTrace as RefColumnarTrace
    from repro.core.trace import StructuralTrace as RefStructuralTrace
    from repro.core.trace import attach_cache_results as ref_attach

    cache = AnalysisCache(store=tmp_path, device="cpu")
    analysis = cache.trace_analysis("NB", CACHE)     # saves trace + flow
    tr = cache.trace("NB", CACHE)
    store = AnalysisStore(tmp_path)
    loaded, flow = store.load_layer1("NB", CACHE.levels, device="cpu")
    got, want = loaded.trace.to_arrays(), tr.trace.to_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]) and got[k].dtype == \
            want[k].dtype, k
    assert loaded.cache.counters() == tr.cache.counters()
    assert [torch.equal(a, b) for a, b in
            zip(loaded.outputs, tr.outputs)] == [True] * len(tr.outputs)
    # the reference's own replay and flow tables of the same trace, array
    # for array
    ref_st = RefStructuralTrace(
        RefColumnarTrace.from_arrays(fixtures.load_arrays("NB")), [])
    ref_tr = ref_attach(ref_st, (R_L1, R_L2))
    ref_arrays = ref_tr.trace.to_arrays()
    for k in ref_arrays:
        assert np.array_equal(got[k], ref_arrays[k]), k
    ref_flow = ref_analyze(ref_tr).flow.to_arrays()
    for k, v in flow.to_arrays().items():
        assert np.array_equal(v, ref_flow[k]), k
    # a rehydrated analysis selects exactly what a fresh one does
    again = rehydrate_analysis(loaded, flow)
    for cfg in (OffloadConfig(), OffloadConfig(cim_levels=("L1",))):
        a, b = analysis.select(cfg), again.select(cfg)
        assert a.candidates == b.candidates and a.claimed == b.claimed


def test_flow_and_selection_pickle_without_a_device(tmp_path):
    analysis = analyze_trace(AnalysisCache(device="cpu").trace("LiR", CACHE))
    flow = analysis.flow
    back = pickle.loads(pickle.dumps(flow))
    assert isinstance(back, FlowIndex) and back.n == flow.n
    for k, v in flow.to_arrays().items():
        assert np.array_equal(back.to_arrays()[k], v), k
    assert back.consumers_of(3) == flow.consumers_of(3)
    again = FlowIndex.from_arrays(flow.to_arrays(), device="cpu")
    assert again.stores_of(5) == flow.stores_of(5)
    res = analysis.select(OffloadConfig())
    shaped = reshape(analysis.trace, res)
    store = AnalysisStore(tmp_path)
    store.save_layer2("LiR", CACHE.levels, OffloadConfig(), res, shaped)
    res2, shaped2 = store.load_layer2("LiR", CACHE.levels, OffloadConfig(),
                                      device="cpu")
    assert res2.candidates == res.candidates and res2.claimed == res.claimed
    assert torch.equal(shaped2.host_seqs, shaped.host_seqs)
    assert (shaped2.cim_groups, shaped2.moves, shaped2.dram_fills) == \
        (shaped.cim_groups, shaped.moves, shaped.dram_fills)
