"""repro_torch.dse.service against repro.dse.service (twin of
``tests/test_service.py`` and of the codec cases of
``tests/test_sampling.py``).

The port's daemon runs on the CPU here (``device="cpu"``: the plain
versions of the replay and placement kernels).  Besides the twins of the
reference's own cases -- single-flight, the codec, the metrics registry,
the HTTP daemon end to end, streaming, the store plane, a warm repeat --
the differential tests send the same request documents to both packages'
``DSEService.handle_query`` and hold the event streams equal (``==``)
after dropping ``elapsed_s`` and ``trace_id``.  Both sides price the
committed traces (the reference reads them through
``reference_on_fixtures``; the port traces its own programs on its VM,
which ``tests/test_torch_workloads.py`` holds to the same fixtures), and
the reference runs under ``EVA_CIM_ACCEL=jax``, whose warm path batches
the replay per workload as the port's always does, so the ``stats`` of
every event are equal on every key: both packages report the same keys
(``trace_builds``, ``trace_hits``, ``offload_builds``, ``offload_hits``,
``replay_batches``), and neither lacks one.

Both packages serve the same two backends (``/healthz`` lists ``["cim",
"tpu"]``); a ``"backend": "tpu"`` request is refused or parsed as the
reference does it, and a TPU space is never priced as CiM.  What differs
by design: the ``/metrics`` ``accel`` block holds the device and the
kernels' launch counts in place of the reference's accel backend and jit
compiles.
"""
import dataclasses
import http.client
import json
import threading
import time

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.dse import service as ref_service

from repro_torch.core import accel
from repro_torch.dse import AnalysisCache, CacheOption, SweepSpace
from repro_torch.dse.results import SweepRecord
from repro_torch.dse.service import (DSEService, MetricsRegistry,
                                     RequestError, ServiceClient,
                                     ServiceError, SingleFlight,
                                     parse_request, running_server)
from repro_torch.dse.service.codec import records_json
from repro_torch.core.sampling import SamplingSpec

from test_torch_dse import reference_on_fixtures


# ------------------------------------------------------------ singleflight
def _spin_until(predicate, deadline_s=10.0):
    """Bounded spin on real shared state (not a sleep-based guess)."""
    deadline = time.monotonic() + deadline_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError("condition never became true")


def test_singleflight_coalesces_concurrent_callers():
    """N concurrent callers of one key: the build runs once, every waiter
    receives the leader's value, counters account for all of them."""
    sf = SingleFlight()
    entered, release = threading.Event(), threading.Event()
    calls = []

    def build():
        calls.append(1)
        entered.set()
        assert release.wait(timeout=10)
        return "artifact"

    results = []

    def caller():
        results.append(sf.do("k", build))

    leader = threading.Thread(target=caller)
    leader.start()
    assert entered.wait(timeout=10)          # the build is now in flight
    waiters = [threading.Thread(target=caller) for _ in range(4)]
    for t in waiters:
        t.start()
    _spin_until(lambda: sf._flights["k"].waiters == 4)
    assert sf.inflight() == 1
    release.set()
    for t in [leader] + waiters:
        t.join(timeout=10)

    assert len(calls) == 1                   # one build for five callers
    assert [v for v, _ in results] == ["artifact"] * 5
    assert sorted(c for _, c in results) == [False] + [True] * 4
    assert sf.started == 1 and sf.coalesced == 4
    assert sf.inflight() == 0


def test_singleflight_error_propagates_but_is_not_cached():
    sf = SingleFlight()
    entered, release = threading.Event(), threading.Event()

    def boom():
        entered.set()
        assert release.wait(timeout=10)
        raise RuntimeError("build failed")

    errors = []

    def caller():
        try:
            sf.do("k", boom)
        except RuntimeError as exc:
            errors.append(str(exc))

    leader = threading.Thread(target=caller)
    leader.start()
    assert entered.wait(timeout=10)
    waiter = threading.Thread(target=caller)
    waiter.start()
    _spin_until(lambda: sf._flights["k"].waiters == 1)
    release.set()
    leader.join(timeout=10)
    waiter.join(timeout=10)
    assert errors == ["build failed"] * 2    # leader AND waiter both see it

    value, coalesced = sf.do("k", lambda: "recovered")
    assert (value, coalesced) == ("recovered", False)
    assert sf.started == 2


def test_singleflight_sequential_calls_each_run():
    """No caching across completed flights — that's the memo's job."""
    sf = SingleFlight()
    assert sf.do("k", lambda: 1) == (1, False)
    assert sf.do("k", lambda: 2) == (2, False)
    assert sf.started == 2 and sf.coalesced == 0


# ------------------------------------------------------------------- codec
def test_parse_request_defaults_and_space():
    req = parse_request({"workloads": ["NB"]})
    assert req["backend"] == "cim" and req["mode"] == "sweep"
    assert isinstance(req["space"], SweepSpace)
    assert len(req["space"]) == 1
    assert req["objectives"] == ("energy_improvement", "speedup")

    req = parse_request({"workloads": ["NB"], "techs": ["sram", "fefet"],
                         "cim_levels": ["L1_only", "both"]})
    assert len(req["space"]) == 4


#: requests both packages refuse with the same message
BAD_REQUESTS = [
    ({"workloads": ["nope"]}, "unknown workload"),
    ({}, "'workloads' is required"),
    ({"workloads": []}, "non-empty list"),
    ({"workloads": ["NB"], "backend": "quantum"}, "unknown backend"),
    ({"workloads": ["NB"], "mode": "exhaustive"}, "unknown mode"),
    ({"workloads": ["NB"], "tpus": ["v5e"]}, "'tpus' is meaningless"),
    ({"workloads": ["NB"], "objectives": ["vibes"]}, "unknown objective"),
    ({"workloads": ["NB"], "max_rounds": -1}, "max_rounds"),
    ({"workloads": ["NB"], "caches": ["1G+2G"]}, "unknown cache preset"),
    ({"workloads": ["NB"], "hosts": ["pentium"]}, "unknown host preset"),
    ({"workloads": ["NB"], "techs": ["memristor"]}, "unknown tech"),
    ({"workloads": ["NB"], "sampling": "simpoint"}, "sampling"),
    ({"workloads": ["KM@64"]}, "sampling"),
    ({"workloads": ["KM@zero"], "sampling": "stratified"}, "scale"),
    (["NB"], "JSON object"),
]
#: the reference's TPU-mode requests: one it prices, four it refuses
TPU_REQUESTS = [
    {"workloads": ["NB"], "backend": "tpu"},
    {"workloads": ["xlstm-125m"], "backend": "tpu", "techs": ["sram"]},
    {"workloads": ["xlstm-125m"], "backend": "tpu", "tpus": ["warp9"]},
    {"workloads": ["xlstm-125m"], "backend": "tpu", "tpus": ["v5e"]},
    {"workloads": ["qwen1.5-0.5b"], "backend": "tpu",
     "sampling": "stratified"},
]


@pytest.mark.parametrize("doc, fragment", BAD_REQUESTS)
def test_parse_request_rejects(doc, fragment):
    with pytest.raises(RequestError, match=fragment):
        parse_request(doc)


@pytest.mark.parametrize("doc", TPU_REQUESTS)
def test_tpu_backend_is_refused_not_priced_as_cim(doc):
    """The one TPU request with a valid arch and TPU-only axes parses into
    a space of TPU points on the "tpu" backend; the other four are
    refused.  None becomes a CiM space."""
    if doc.get("tpus") != ["v5e"]:
        with pytest.raises(RequestError):
            parse_request(doc)
        return
    req = parse_request(doc)
    assert req["backend"] == "tpu"
    assert [p.tpu is not None for p in req["space"]] == [True]
    assert req["space"].points()[0].label == "xlstm-125m/v5e/thr64K"


def test_records_json_sanitizes_nonfinite():
    fields = {f.name: (float("nan") if f.type == "float" else 0)
              for f in dataclasses.fields(SweepRecord)}
    fields.update(workload="NB", cache="32K+256K", cim_levels="L1",
                  tech="sram", cim_set="stt", host="default", backend="cim",
                  speedup=float("inf"), energy_improvement=2.0)
    (doc,) = records_json([SweepRecord(**fields)])
    assert doc["speedup"] is None                  # inf -> null
    assert doc["energy_improvement"] == 2.0
    json.dumps(doc, allow_nan=False)               # strict-JSON clean


# twins of the codec cases of tests/test_sampling.py
def test_codec_accepts_sampling_string_and_dict():
    req = parse_request({"workloads": ["KM"],
                         "sampling": "stratified:interval=256,budget=4"})
    assert req["sampling"] == SamplingSpec(mode="stratified", interval=256,
                                           budget=4)
    req = parse_request({"workloads": ["KM"],
                         "sampling": {"mode": "phase", "seed": 2}})
    assert req["sampling"] == SamplingSpec(mode="phase", seed=2)
    assert parse_request({"workloads": ["KM"]})["sampling"].is_exact


@pytest.mark.parametrize("doc,fragment", [
    ({"workloads": ["qwen1.5-0.5b"], "backend": "tpu",
      "sampling": "stratified"}, "tpu"),
    ({"workloads": ["KM"], "sampling": "simpoint"}, "sampling"),
    ({"workloads": ["KM"], "sampling": {"mode": "phase", "windows": 4}},
     "sampling"),
    ({"workloads": ["KM@64"]}, "sampling"),
    ({"workloads": ["KM@zero"], "sampling": "stratified"}, "scale"),
])
def test_codec_rejects_bad_sampling(doc, fragment):
    with pytest.raises(RequestError) as err:
        parse_request(doc)
    assert fragment in str(err.value)


def test_codec_scaled_workload_with_sampling_ok():
    req = parse_request({"workloads": ["KM@64"], "sampling": "stratified"})
    assert req["space"].workloads == ("KM@64",)
    assert req["sampling"].mode == "stratified"


@pytest.mark.parametrize("doc", [d for d, _ in BAD_REQUESTS])
def test_bad_request_messages_equal_reference(doc):
    with pytest.raises(ref_service.RequestError) as want:
        ref_service.parse_request(doc)
    with pytest.raises(RequestError) as got:
        parse_request(doc)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("doc", TPU_REQUESTS)
def test_tpu_requests_are_400_in_both(doc):
    """A TPU request the reference refuses (a 400) the port refuses with
    the same message; one the reference accepts the port parses into the
    same space, point for point."""
    try:
        want = ref_service.parse_request(doc)
    except ref_service.RequestError as exc:
        with pytest.raises(RequestError) as got:
            parse_request(doc)
        assert str(got.value) == str(exc)
        return
    got = parse_request(doc)
    assert got["backend"] == want["backend"] == "tpu"
    assert [p.label for p in got["space"]] == \
        [p.label for p in want["space"]]
    assert [dataclasses.asdict(p.tpu) for p in got["space"]] == \
        [dataclasses.asdict(p.tpu) for p in want["space"]]


# ----------------------------------------------------------------- metrics
def test_metrics_registry_snapshot():
    m = MetricsRegistry()
    m.counter("points.requested", by=3)
    m.counter("points.requested")
    m.gauge_inc("inflight")
    m.gauge_inc("inflight")
    m.gauge_dec("inflight")
    for v in (0.1, 0.2, 0.3):
        m.observe("latency_s.sweep", v)
    snap = m.snapshot()
    assert snap["points"]["requested"] == 4
    assert snap["inflight"] == 1
    hist = snap["latency_s"]["sweep"]
    assert hist["count"] == 3
    assert hist["max"] == pytest.approx(0.3)
    assert hist["p50"] == pytest.approx(0.2)
    assert m.counter_value("points.requested") == 4


# ------------------------------------------------------------- HTTP daemon
@pytest.fixture(scope="module")
def daemon():
    with running_server(max_workers=4, device="cpu") as (url, service):
        yield url, ServiceClient(url), service


def test_service_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    from repro_torch import obs
    before = obs.tracer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DSEService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with running_server():
            pass
    assert obs.tracer() is before       # nothing installed on the way out


def test_healthz_and_unknown_paths(daemon):
    url, client, _service = daemon
    health = client.healthz()
    assert health["status"] == "ok"
    assert health["backends"] == ["cim", "tpu"]
    with pytest.raises(ServiceError) as err:
        client._get_json("/nope")
    assert err.value.status == 404


def test_sweep_end_to_end(daemon):
    _url, client, _service = daemon
    events = list(client.stream({"workloads": ["NB"],
                                 "techs": ["sram", "fefet"]}))
    assert [e["event"] for e in events] == ["start", "result"]
    assert events[0]["n_points"] == 2
    reply = client.sweep(["NB"], techs=["sram", "fefet"])
    assert len(reply.records) == 2
    assert {r["tech"] for r in reply.records} == {"sram", "fefet"}
    assert all(r["energy_improvement"] > 0 for r in reply.records)
    assert 1 <= len(reply.frontier) <= 2


def test_bad_requests_are_400_not_streams(daemon):
    _url, client, _service = daemon
    for doc in ({"workloads": ["nope"]},
                {"workloads": ["NB"], "backend": "tpu",
                 "techs": ["sram"]},
                {"workloads": ["NB"], "backend": "tpu"},
                {"workloads": ["NB"], "objectives": ["vibes"]}):
        with pytest.raises(ServiceError) as err:
            list(client.stream(doc))
        assert err.value.status == 400

    conn = http.client.HTTPConnection(client.host, client.port, timeout=30)
    try:
        conn.request("POST", "/v1/sweep", body=b"not json{",
                     headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
    finally:
        conn.close()


def test_warm_repeat_does_zero_work(daemon):
    """A warm daemon answers a repeated exhaustive sweep with zero new
    trace builds (and zero new evaluations)."""
    _url, client, service = daemon
    req = dict(caches=["32K+256K", "64K+256K"], techs=["sram"])
    client.sweep(["NB"], **req)                        # warm it
    m1 = client.metrics()
    reply = client.sweep(["NB"], **req)                # repeat, warm
    m2 = client.metrics()
    assert len(reply.records) == 2
    assert (m2["service"]["points"]["evaluated"]
            == m1["service"]["points"]["evaluated"])
    assert (m2["cache"]["cim"]["layer1"]["builds"]
            == m1["cache"]["cim"]["layer1"]["builds"])
    assert (m2["service"]["points"]["memo_hits"]
            > m1["service"]["points"]["memo_hits"])


def test_concurrent_overlapping_sweeps_dedup(daemon):
    """Four concurrent identical requests on a cold workload: the daemon
    evaluates each unique SweepPoint.key exactly once."""
    url, client, _service = daemon
    m0 = client.metrics()["service"]["points"]
    barrier = threading.Barrier(4)
    failures = []

    def storm():
        local = ServiceClient(url)
        barrier.wait()
        try:
            reply = local.sweep(["LCS"], techs=["sram", "fefet"])
            assert len(reply.records) == 2
        except Exception as exc:  # noqa: BLE001 — surfaced below
            failures.append(exc)

    threads = [threading.Thread(target=storm) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not failures
    m1 = client.metrics()["service"]["points"]
    assert m1["requested"] - m0["requested"] == 8      # 4 clients x 2 points
    assert m1["evaluated"] - m0["evaluated"] == 2      # == unique keys
    saved = (m1["coalesced"] - m0["coalesced"]) + \
        (m1["memo_hits"] - m0["memo_hits"])
    assert saved == 6                                  # every duplicate


def test_storm_under_short_switch_interval_loses_no_point():
    """Eight clients at once on a cold daemon, with the interpreter
    switching threads every microsecond: every point is requested,
    evaluated once per unique key, and answered from the memo or a
    shared flight otherwise; a lost update in the memo, the single-flight
    table or the counters breaks one of these."""
    import sys
    from repro_torch.bench.service import client_space, unique_keys

    docs = [client_space(i, ("NB",)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with running_server(max_workers=4, device="cpu") as (url, _):
            barrier = threading.Barrier(len(docs))
            errors, counts = [], []

            def one(doc):
                barrier.wait()
                try:
                    reply = ServiceClient(url).sweep(
                        doc["workloads"], caches=doc["caches"],
                        cim_levels=doc["cim_levels"], techs=doc["techs"])
                    counts.append(len(reply.records))
                except Exception as exc:  # noqa: BLE001 — surfaced below
                    errors.append(exc)

            threads = [threading.Thread(target=one, args=(d,))
                       for d in docs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            pts = ServiceClient(url).metrics()["service"]["points"]
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert pts["requested"] == sum(counts) == sum(
        len(SweepSpace(workloads=tuple(d["workloads"]),
                       caches=tuple(d["caches"]),
                       cim_levels=tuple(d["cim_levels"]),
                       techs=tuple(d["techs"]))) for d in docs)
    assert pts["evaluated"] == unique_keys(docs)
    assert pts["coalesced"] + pts["memo_hits"] == \
        pts["requested"] - pts["evaluated"]


def test_flight_started_after_a_finished_flight_reads_the_memo():
    """Call A misses the memo, then waits before it starts its flight;
    call B, on the same key, evaluates and returns in that gap.  A's
    flight must answer from the memo: one evaluation of the key, and A
    counted as a memo hit (a second evaluation is the check-then-act race
    the storm test trips on under a short switch interval)."""
    service = DSEService(max_workers=1, tracing=False, device="cpu")
    backend, cache = service._backends["cim"], service.analysis_cache("cim")
    point = SweepSpace(workloads=("NB",), techs=("sram",)).points()[0]
    real_do = service._singleflight.do
    a_missed, b_returned = threading.Event(), threading.Event()
    calls, calls_lock = [], threading.Lock()

    def do(key, fn):
        with calls_lock:
            calls.append(key)
            first = len(calls) == 1
        if first:                    # call A, after its memo miss
            a_missed.set()
            assert b_returned.wait(timeout=120)
        return real_do(key, fn)

    service._singleflight.do = do
    out = {}

    def call_a():
        out["a"] = service.evaluate_point(backend, cache, point, service.host)

    thread = threading.Thread(target=call_a)
    thread.start()
    assert a_missed.wait(timeout=120)
    out["b"] = service.evaluate_point(backend, cache, point, service.host)
    b_returned.set()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert calls == [calls[0], calls[0]]           # one key, both flights
    value = service.metrics.counter_value
    assert value("points.requested") == 2
    assert value("points.evaluated") == 1
    assert value("points.coalesced") + value("points.memo_hits") == 1
    assert out["a"] == out["b"]


def test_metrics_snapshot_shape(daemon):
    _url, client, _service = daemon
    doc = client.metrics()
    assert doc["uptime_s"] >= 0
    assert doc["dedup_ratio"] is None or doc["dedup_ratio"] >= 1
    assert list(doc["cache"]) == ["cim", "tpu"]
    for backend in ("cim", "tpu"):
        for layer in ("layer1", "layer2"):
            stats = doc["cache"][backend][layer]
            assert set(stats) == {"builds", "hits", "hit_rate"}
    assert doc["accel"] == {"device": "cpu",
                            "launches": accel.launch_counts()}
    assert "store" not in doc                # no cache_dir on this daemon
    assert doc["service"]["requests"]["sweep"] >= 1
    assert doc["service"]["latency_s"]["sweep"]["count"] >= 1


def test_adaptive_end_to_end(daemon):
    _url, client, _service = daemon
    events = list(client.adaptive_events(
        ["NB"], caches=["32K+256K", "64K+256K"],
        cim_levels=["L1_only", "both"], max_rounds=4))
    kinds = [e["event"] for e in events]
    assert kinds[0] == "start" and kinds[-1] == "result"
    rounds = [e for e in events if e["event"] == "round"]
    assert rounds and [r["round"] for r in rounds] == list(range(len(rounds)))
    assert all("frontier" in r for r in rounds)
    assert events[-1]["n_records"] >= rounds[0]["n_priced"]


def test_warm_repeat_builds_and_launches_nothing(daemon):
    """In place of the reference's jit-recompile case: a repeated sweep
    over three geometries adds no trace build, no selection build and no
    batched replay; on the CPU no kernel launches at all (the plain
    versions run), and a fresh cache replays the three geometries in one
    batch."""
    _url, client, _service = daemon
    req = dict(caches=["32K+256K", "64K+256K", "64K+2M"], techs=["sram"])
    accel.reset_launch_counts()
    client.sweep(["KM"], **req)                        # cold
    m1 = client.metrics()
    assert m1["cache"]["cim"]["replay_batches"] >= 1
    client.sweep(["KM"], **req)                        # warm repeat
    m2 = client.metrics()
    for layer in ("layer1", "layer2"):
        assert (m2["cache"]["cim"][layer]["builds"]
                == m1["cache"]["cim"][layer]["builds"])
    assert (m2["cache"]["cim"]["replay_batches"]
            == m1["cache"]["cim"]["replay_batches"])
    assert m2["accel"]["launches"] == dict.fromkeys(accel.KERNELS, 0)

    fresh = AnalysisCache(device="cpu")
    fresh.replay_group("KM", [CacheOption.of(n) for n in req["caches"]])
    assert fresh.replay_batches == 1 and fresh.trace_builds == 3


# -------------------------------------------------- event-driven streaming
def test_round_events_stream_while_server_still_running(monkeypatch):
    """The client must receive round 0 while the server's generator is
    still *blocked* on an event only the client-side test releases."""
    import repro_torch.dse.service.server as server_mod
    from repro_torch.dse.adaptive import RoundEvent, RoundInfo
    from repro_torch.dse.results import SweepResults

    gate = threading.Event()

    def make_info(n, stable):
        return RoundInfo(round=n, n_candidates=1, n_priced=1,
                         frontier_size=0, stable=stable, stats={},
                         elapsed_s=0.0)

    class StubAdaptive:
        def __init__(self, space, engine=None, objectives=None,
                     max_rounds=None):
            pass

        def run_iter(self):
            yield RoundEvent(info=make_info(0, False), frontier=[],
                             results=SweepResults(records=[]))
            if not gate.wait(timeout=30):
                raise RuntimeError("client never received round 0")
            yield RoundEvent(info=make_info(1, True), frontier=[],
                             results=SweepResults(records=[]))

    monkeypatch.setattr(server_mod, "AdaptiveDSE", StubAdaptive)
    with running_server(device="cpu") as (url, _service):
        events = ServiceClient(url).stream({"workloads": ["NB"],
                                            "mode": "adaptive"})
        assert next(events)["event"] == "start"
        first_round = next(events)           # server is parked on `gate`
        assert (first_round["event"], first_round["round"]) == ("round", 0)
        gate.set()                           # only now may round 1 exist
        rest = list(events)
        assert [(e["event"], e.get("round")) for e in rest] == \
            [("round", 1), ("result", None)]
        assert rest[-1]["n_rounds"] == 2


def test_midstream_failure_is_inband_error(monkeypatch):
    """Failures after the 200 commits travel as a terminal error event."""
    import repro_torch.dse.service.server as server_mod

    class ExplodingAdaptive:
        def __init__(self, *a, **k):
            pass

        def run_iter(self):
            raise RuntimeError("pricing exploded")
            yield  # noqa: unreachable — makes this a generator

    monkeypatch.setattr(server_mod, "AdaptiveDSE", ExplodingAdaptive)
    with running_server(device="cpu") as (url, _service):
        events = ServiceClient(url).stream({"workloads": ["NB"],
                                            "mode": "adaptive"})
        assert next(events)["event"] == "start"
        with pytest.raises(ServiceError, match="pricing exploded"):
            list(events)


# ---------------------------------------------------- persistent store plane
def test_store_metrics_and_corrupt_drops_surface(tmp_path):
    """/metrics carries the store counters; a daemon restarted over a
    corrupted cache dir reports the drop."""
    with running_server(cache_dir=str(tmp_path),
                        device="cpu") as (url, _service):
        client = ServiceClient(url)
        client.sweep(["NB"])
        doc = client.metrics()
        assert doc["store"]["corrupt_drops"] == 0
        assert doc["store"]["store_writes"] >= 2

    (blob,) = (p for p in (tmp_path / "layer1").glob("*.npz")
               if ".flow" not in p.name)          # the trace artifact
    blob.write_bytes(b"bit rot")

    with running_server(cache_dir=str(tmp_path),
                        device="cpu") as (url, _service):
        client = ServiceClient(url)
        reply = client.sweep(["NB"])          # rebuilds through the rot
        assert len(reply.records) == 1
        doc = client.metrics()
        assert doc["store"]["corrupt_drops"] == 1
        assert doc["store"]["store_corrupt_drops"] == 1


# ------------------------------------------------ differential: both daemons
DIFF_REQUESTS = {
    "sweep": {"workloads": ["NB"], "caches": ["32K+256K", "64K+2M"],
              "cim_levels": ["L1_only", "both"], "techs": ["sram", "fefet"]},
    "repeat": {"workloads": ["NB"], "caches": ["64K+2M", "32K+256K"],
               "cim_levels": ["both"], "techs": ["fefet", "sram"]},
    "adaptive": {"workloads": ["NB"], "mode": "adaptive",
                 "caches": ["32K+256K", "64K+256K", "64K+2M"],
                 "cim_levels": ["L1_only", "L2_only", "both"],
                 "techs": ["sram", "fefet"], "max_rounds": 4},
    "sampled": {"workloads": ["NB@8"], "sampling": "stratified",
                "techs": ["sram", "fefet"]},
}


def _strip(event):
    """An event without its wall-clock and trace-id fields."""
    out = {k: v for k, v in event.items()
           if k not in ("elapsed_s", "trace_id")}
    return json.loads(json.dumps(out))


@pytest.fixture(scope="module")
def both_streams():
    """Every request of ``DIFF_REQUESTS``, in order, through one daemon
    of each package (no HTTP: ``handle_query`` yields the events)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("EVA_CIM_ACCEL", "jax")
    try:
        with reference_on_fixtures():
            ref = ref_service.DSEService(max_workers=4, tracing=False)
            want = {name: [_strip(e) for e in ref.handle_query(dict(doc))]
                    for name, doc in DIFF_REQUESTS.items()}
            ref_metrics = ref.metrics_snapshot()
    finally:
        mp.undo()
    port = DSEService(max_workers=4, tracing=False, device="cpu")
    got = {name: [_strip(e) for e in port.handle_query(dict(doc))]
           for name, doc in DIFF_REQUESTS.items()}
    return got, want, port.metrics_snapshot(), ref_metrics


@pytest.mark.parametrize("name", DIFF_REQUESTS)
def test_event_streams_equal_reference(both_streams, name):
    got, want, _, _ = both_streams
    assert [e["event"] for e in got[name]] == \
        [e["event"] for e in want[name]]
    for g, w in zip(got[name], want[name]):
        if "stats" in w:
            assert set(g["stats"]) == set(w["stats"])
        assert g == w


def test_stream_shapes_are_what_the_requests_ask(both_streams):
    got, _, _, _ = both_streams
    start, result = got["sweep"]
    assert start == {"event": "start", "backend": "cim", "mode": "sweep",
                     "n_points": 8, "n_analyses": 2}
    assert result["n_records"] == 8 and result["stats"]["replay_batches"] \
        == 1
    # the repeat is priced from the memo alone: its warm pass only reads
    # the two traces back
    stats = got["repeat"][-1]["stats"]
    assert (stats["trace_builds"], stats["offload_builds"],
            stats["replay_batches"], stats["offload_hits"]) == (0, 0, 0, 0)
    rounds = [e for e in got["adaptive"] if e["event"] == "round"]
    assert [r["round"] for r in rounds] == list(range(len(rounds)))
    assert rounds[-1]["stable"] or len(rounds) == 5
    sampled = got["sampled"]
    assert sampled[0]["sampling"] == SamplingSpec(mode="stratified").key()
    assert {r["sampling"] for r in sampled[-1]["records"]} == \
        {sampled[0]["sampling"]}


def test_service_counters_equal_reference(both_streams):
    _, _, port_m, ref_m = both_streams
    assert port_m["service"]["points"] == ref_m["service"]["points"]
    assert port_m["dedup_ratio"] == ref_m["dedup_ratio"]
    assert port_m["memo_records"] == ref_m["memo_records"]
    assert port_m["cache"]["cim"] == ref_m["cache"]["cim"]


def _small_storm(url, clients=2):
    """``clients`` concurrent NB sweeps over rotated, overlapping slices
    of the Fig. 14/15 axes; returns the daemon's point counters and the
    unique keys the storm asks for."""
    from repro_torch.bench.service import client_space
    docs = [client_space(i, ("NB",)) for i in range(clients)]
    barrier = threading.Barrier(clients)
    errors = []

    def one(doc):
        barrier.wait()
        try:
            ServiceClient(url).sweep(doc["workloads"], caches=doc["caches"],
                                     cim_levels=doc["cim_levels"],
                                     techs=doc["techs"])
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(d,)) for d in docs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors
    keys = {p.key for d in docs for p in SweepSpace(
        workloads=tuple(d["workloads"]), caches=tuple(d["caches"]),
        cim_levels=tuple(d["cim_levels"]), techs=tuple(d["techs"])).points()}
    pts = ServiceClient(url).metrics()["service"]["points"]
    return pts["requested"], pts["evaluated"], len(keys)


def test_small_storm_counts_equal_reference():
    with reference_on_fixtures(), \
            ref_service.running_server(max_workers=4) as (url, _):
        want = _small_storm(url)
    with running_server(max_workers=4, device="cpu") as (url, _):
        got = _small_storm(url)
    assert got == want
    requested, evaluated, unique = got
    assert evaluated == unique and requested > evaluated
