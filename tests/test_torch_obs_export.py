"""repro_torch.obs exporters against repro.obs (twin of the export,
attribution, tree, service-trace and metrics-nesting cases of
``tests/test_obs.py``).

The differential case sends one fixed list of span and counter dicts
through both packages' ``export_chrome``, ``export_ndjson``,
``build_tree``, ``stage_attribution`` and ``attribution_markdown``; every
output must be equal (``==``), apart from the Chrome document's
``otherData.producer``, which names each package.  The traced example CLI
(``tests/test_obs.py``'s ``examples/dse_cim.py --trace-report`` case)
waits for the port of that example.
"""
import copy
import io
import json

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro import obs as ref_obs

from repro_torch import obs
from repro_torch.dse import AdaptiveDSE, DSEEngine, SweepSpace
from repro_torch.dse.service import (MetricsRegistry, ServiceClient,
                                     ServiceError, running_server)
from repro_torch.dse.service.metrics import Histogram


@pytest.fixture(autouse=True)
def _no_tracer_leaks():
    """Every test starts and ends with tracing off in both packages."""
    obs.disable()
    ref_obs.disable()
    yield
    obs.disable()
    ref_obs.disable()


def _space():
    return SweepSpace(workloads=("NB",), caches=("32K+256K", "64K+2M"),
                      cim_levels=("L1_only", "both"))


def test_adaptive_rounds_traced():
    t = obs.enable(obs.Tracer())
    space = _space()
    AdaptiveDSE(space, engine=DSEEngine(executor="serial",
                                        device="cpu")).run()
    rounds = [s for s in t.spans() if s["name"] == "adaptive.round"]
    assert rounds
    assert [s["attrs"]["round"] for s in rounds] == list(range(len(rounds)))
    assert all("frontier_size" in s["attrs"] for s in rounds)
    assert rounds[-1]["attrs"]["stable"] is True


# ------------------------------------------------------- chrome export
def test_chrome_export_is_perfetto_valid(tmp_path):
    t = obs.enable(obs.Tracer())
    DSEEngine(executor="serial", device="cpu").run(_space())
    obs.counter("points", 4.0)
    path = tmp_path / "trace.json"
    n = t.export_chrome(path)
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert doc["otherData"]["producer"] == "repro_torch.obs"
    events = doc["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == n == doc["otherData"]["spans"] == len(t.spans()) > 0
    for e in xs:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                "args"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0
    assert min(e["ts"] for e in events if e["ph"] in "XC") == \
        pytest.approx(0.0)
    by_id = {e["args"]["span_id"]: e for e in xs}
    for e in xs:
        ref = e["args"].get("parent_id")
        if ref:
            p = by_id[ref]
            assert e["ts"] >= p["ts"] - 1e-3
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    cs = [e for e in events if e["ph"] == "C"]
    assert cs and all("value" in e["args"] for e in cs)
    names = {e["name"] for e in events if e["ph"] == "M"}
    assert {"process_name", "thread_name"} <= names


def test_ndjson_export_round_trips(tmp_path):
    t = obs.enable(obs.Tracer())
    with obs.span("a", cat="x", k=1):
        pass
    path = tmp_path / "spans.ndjson"
    assert t.export_ndjson(path) == 1
    (line,) = path.read_text().splitlines()
    rec = json.loads(line)
    assert rec["name"] == "a" and rec["attrs"] == {"k": 1}


def test_tracer_stage_attribution_covers_its_spans():
    t = obs.enable(obs.Tracer())
    DSEEngine(executor="serial", device="cpu").run(_space())
    att = t.stage_attribution()
    assert att == obs.stage_attribution(t.spans())
    assert att["n_spans"] == len(t.spans())
    assert 0.95 <= att["coverage"] <= 1.05      # serial: self times telescope


# ----------------------------------------------------------- attribution
def _synth(sid, parent, cat, ts, dur, **attrs):
    return {"name": sid, "cat": cat, "trace_id": "t", "span_id": sid,
            "parent_id": parent, "ts_ns": ts, "dur_ns": dur,
            "pid": 1, "tid": 1, "thread": "main", "attrs": attrs}


def test_stage_attribution_self_time_and_hit_rates():
    spans = [
        _synth("root", None, "engine", 0, 100),
        _synth("a", "root", "trace", 0, 60, source="build", workload="NB"),
        _synth("b", "root", "select", 60, 30, source="memo", workload="NB"),
    ]
    att = obs.stage_attribution(spans)
    assert att["wall_s"] == pytest.approx(100e-9)
    assert att["attributed_s"] == pytest.approx(100e-9)
    assert att["coverage"] == pytest.approx(1.0)
    assert att["stages"]["engine"]["self_s"] == pytest.approx(10e-9)
    assert att["stages"]["trace"]["hit_rate"] == 0.0
    assert att["stages"]["select"]["hit_rate"] == 1.0
    assert att["workloads"]["NB"]["trace"] == pytest.approx(60e-9)
    md = obs.attribution_markdown(att)
    assert "| stage |" in md and "| trace |" in md and "| NB |" in md


def test_stage_attribution_orphans_count_as_roots():
    att = obs.stage_attribution([_synth("x", "missing", "trace", 0, 50)])
    assert att["wall_s"] == pytest.approx(50e-9)
    assert att["coverage"] == pytest.approx(1.0)


def test_build_tree_nests_children_and_orphans():
    spans = [_synth("root", None, "engine", 0, 100),
             _synth("kid2", "root", "select", 60, 30),
             _synth("kid1", "root", "trace", 0, 60),
             _synth("lost", "missing", "price", 5, 1)]
    roots = obs.build_tree(spans)
    assert [r["span_id"] for r in roots] == ["root", "lost"]
    assert [c["span_id"] for c in roots[0]["children"]] == ["kid1", "kid2"]


# ------------------------------------------ differential: both exporters
#: spans of two traces over two processes and three threads: nesting,
#: an orphan, a zero-length span, a misc (empty) category, hit and miss
#: sources, workloads, parallel children that overlap their parent
SPANS = [
    dict(_synth("r1", None, "service", 1_000, 9_000), trace_id="t1",
         thread="MainThread"),
    dict(_synth("e1", "r1", "engine", 1_500, 8_000, workload="NB"),
         trace_id="t1", tid=2, thread="dse-worker-0"),
    dict(_synth("a1", "e1", "trace", 1_600, 3_000, source="build",
                workload="NB", layer=1), trace_id="t1", tid=2,
         thread="dse-worker-0"),
    dict(_synth("s1", "e1", "select", 4_700, 2_000, source="memo",
                workload="NB"), trace_id="t1", tid=3, thread=None),
    dict(_synth("s2", "e1", "select", 4_800, 4_000, source="coalesced",
                workload="KM"), trace_id="t1", tid=3, thread=None),
    dict(_synth("p1", "s1", "price", 4_900, 0, source="evaluated",
                workload="NB"), trace_id="t1", pid=7, tid=1),
    dict(_synth("o1", "gone", "", 2_000, 700, source="store"),
         trace_id="t1", pid=7, tid=4, thread="worker"),
    dict(_synth("r2", None, "service", 12_000, 4_000, endpoint="adaptive"),
         trace_id="t2", thread="MainThread"),
    dict(_synth("x2", "r2", "adaptive", 12_500, 3_000, round=0,
                stable=False), trace_id="t2"),
]
COUNTERS = [
    {"name": "points", "value": 4.0, "ts_ns": 500, "pid": 1},
    {"name": "points", "value": 9.0, "ts_ns": 13_000, "pid": 7},
]


def test_exports_equal_reference_on_the_same_spans():
    bufs = {}
    for name, pkg in (("ref", ref_obs), ("port", obs)):
        chrome, nd = io.StringIO(), io.StringIO()
        n = pkg.export_chrome(copy.deepcopy(SPANS), copy.deepcopy(COUNTERS),
                              chrome, name="evacim")
        m = pkg.export_ndjson(copy.deepcopy(SPANS), nd)
        att = pkg.stage_attribution(copy.deepcopy(SPANS))
        bufs[name] = dict(n=n, m=m, chrome=json.loads(chrome.getvalue()),
                          ndjson=nd.getvalue(),
                          tree=pkg.build_tree(copy.deepcopy(SPANS)),
                          att=att, md=pkg.attribution_markdown(att))
    ref, port = bufs["ref"], bufs["port"]
    assert ref["chrome"]["otherData"].pop("producer") == "repro.obs"
    assert port["chrome"]["otherData"].pop("producer") == "repro_torch.obs"
    assert port == ref
    assert port["n"] == len(SPANS) and port["m"] == len(SPANS)
    assert port["att"]["coverage"] > 1.0           # overlapped children


# -------------------------------------------------- daemon tracing plane
def test_service_requests_traced_and_queryable():
    with running_server(max_workers=4, device="cpu") as (url, service):
        client = ServiceClient(url)
        r1 = client.sweep(["NB"], caches=["32K+256K"])
        r2 = client.sweep(["NB"], caches=["32K+256K", "64K+2M"])
        assert r1.trace_id and r2.trace_id
        assert r1.trace_id != r2.trace_id      # one root span per request
        tree = client.trace(r2.trace_id)
        assert tree["trace_id"] == r2.trace_id
        (root,) = tree["spans"]
        assert root["name"] == "http.sweep" and root["children"]
        assert tree["n_spans"] >= 2
        with pytest.raises(ServiceError) as exc:
            client.trace("0" * 16)
        assert exc.value.status == 404
        m = client.metrics()
        assert m["obs"]["tracing"] is True
        assert m["obs"]["buffered_traces"] == 2
        assert m["obs"]["dropped_spans"] == 0
        assert m["service"]["obs"]["spans"] >= tree["n_spans"]
        assert m["service"]["obs"]["stage_self_s"]
        spans = service.buffered_spans()
        assert len({s["trace_id"] for s in spans}) == 2
        assert obs.stage_attribution(spans)["n_spans"] == len(spans)
    # running_server owned the tracer, so exit restores tracing-off
    assert obs.tracer() is None


def test_service_leaves_a_callers_tracer_installed():
    mine = obs.enable(obs.Tracer())
    with running_server(device="cpu") as (url, _service):
        reply = ServiceClient(url).sweep(["NB"])
        assert reply.trace_id
    assert obs.tracer() is mine


# ------------------------------------- metrics registry nesting rules
def test_metrics_nest_leaf_then_branch_keeps_both():
    reg = MetricsRegistry()
    reg.counter("a")
    reg.gauge_inc("a.b", 2)
    snap = reg.snapshot()
    assert snap["a"] == 1
    assert snap["a.b"] == 2          # literal dotted key, not dropped


def test_metrics_nest_branch_then_leaf_keeps_both():
    reg = MetricsRegistry()
    reg.counter("a.b")
    reg.gauge_inc("a", 5)
    snap = reg.snapshot()
    assert snap["a"]["b"] == 1
    assert snap["a."] == 5           # dotless name vs branch: "." suffix


def test_metrics_nest_same_kind_clash():
    reg = MetricsRegistry()
    reg.counter("x", 3)
    reg.counter("x.y", 7)
    snap = reg.snapshot()
    assert snap["x"] == 3 and snap["x.y"] == 7


def test_metrics_nest_plain_paths_untouched():
    reg = MetricsRegistry()
    reg.counter("requests.sweep", 2)
    reg.gauge_inc("inflight", 1)
    snap = reg.snapshot()
    assert snap["requests"]["sweep"] == 2 and snap["inflight"] == 1


def test_metrics_snapshots_equal_reference():
    from repro.dse.service import MetricsRegistry as RefRegistry
    snaps = []
    for cls in (RefRegistry, MetricsRegistry):
        reg = cls()
        reg.counter("a")
        reg.gauge_inc("a.b", 2)
        reg.counter("c.d")
        reg.gauge_inc("c", 5)
        reg.counter("requests.sweep", 3)
        for v in (0.5, 0.1, 0.3, 0.2):
            reg.observe("latency_s.sweep", v)
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]


def test_histogram_quantile_matches_snapshot():
    h = Histogram()
    for v in (5.0, 1.0, 3.0, 2.0, 4.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["p50"] == h.quantile(0.50) == 3.0
    assert snap["p90"] == h.quantile(0.90) == 5.0
    assert snap["p99"] == h.quantile(0.99) == 5.0
    assert snap["count"] == 5 and snap["max"] == 5.0
    empty = Histogram()
    assert empty.quantile(0.5) is None
    assert empty.snapshot()["p50"] is None
