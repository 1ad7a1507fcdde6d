"""repro_torch.obs's readings beyond the reference's record: each span's
thread CPU time (``cpu_ns``), the collector's pauses charged to the
innermost open span (``gc_n`` / ``gc_ns``, else the tracer's
``gc_unattributed_*``), their exports, and the inner spans of Algorithm 1
and pricing on a traced CPU sweep."""
import dataclasses
import gc
import io
import json
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch import obs
from repro_torch.dse import DSEEngine, SweepSpace

MS = 1_000_000


@pytest.fixture(autouse=True)
def _no_tracer_leaks():
    obs.disable()
    yield
    obs.disable()


@pytest.fixture
def manual_gc():
    """Automatic collections off: only the test's own ``gc.collect()``
    calls pause the thread."""
    was = gc.isenabled()
    gc.disable()
    yield
    if was:
        gc.enable()


def _by_name(tracer):
    return {s["name"]: s for s in tracer.spans()}


# ------------------------------------------------------------- cpu_ns
def test_cpu_ns_is_near_zero_for_a_sleep():
    t = obs.enable(obs.Tracer())
    c0 = time.thread_time_ns()
    with obs.span("nap"):
        time.sleep(0.05)
    c1 = time.thread_time_ns()
    (rec,) = t.spans()
    assert 0 <= rec["cpu_ns"] <= c1 - c0
    assert rec["dur_ns"] >= 50 * MS
    assert rec["cpu_ns"] < 0.2 * rec["dur_ns"]


def test_cpu_ns_follows_the_threads_time_in_a_busy_loop():
    t = obs.enable(obs.Tracer())
    c0, w0 = time.thread_time_ns(), time.perf_counter_ns()
    with obs.span("spin"):
        end = time.thread_time_ns() + 30 * MS
        while time.thread_time_ns() < end:
            pass
    c1, w1 = time.thread_time_ns(), time.perf_counter_ns()
    (rec,) = t.spans()
    # the loop burnt 30 ms of this thread's time inside the span, and the
    # span reads no more than the bracket around it did
    assert 30 * MS <= rec["cpu_ns"] <= c1 - c0
    assert rec["cpu_ns"] <= rec["dur_ns"] + MS
    # whatever the span did not spend on the CPU, the bracket did not
    # either: the time off the CPU is what the machine's load took
    assert rec["dur_ns"] - rec["cpu_ns"] <= (w1 - w0) - (c1 - c0) + MS


# ---------------------------------------------------- collector pauses
def test_a_collection_is_charged_to_the_innermost_span(manual_gc):
    t = obs.enable(obs.Tracer())
    with obs.span("outer"):
        with obs.span("inner"):
            gc.collect()
            gc.collect()
        with obs.span("sibling"):
            pass
    spans = _by_name(t)
    assert spans["inner"]["attrs"]["gc_n"] == 2
    assert 0 < spans["inner"]["attrs"]["gc_ns"] <= spans["inner"]["dur_ns"]
    for name in ("outer", "sibling"):
        assert "gc_n" not in spans[name]["attrs"]
        assert "gc_ns" not in spans[name]["attrs"]
    assert t.gc_unattributed_n == 0 and t.gc_unattributed_ns == 0


def test_a_collection_outside_every_span_is_counted_on_the_tracer(
        manual_gc):
    t = obs.enable(obs.Tracer())
    with obs.span("done"):
        pass
    gc.collect()
    assert t.gc_unattributed_n == 1 and t.gc_unattributed_ns > 0
    assert "gc_n" not in t.spans()[0]["attrs"]


def test_a_pool_thread_under_attach_charges_its_own_innermost_span(
        manual_gc):
    t = obs.enable(obs.Tracer())

    def work(ctx):
        with obs.attach(ctx):
            gc.collect()              # no span open in this thread
            with obs.span("leaf"):
                with obs.span("twig"):
                    gc.collect()

    with obs.span("root") as root:
        with ThreadPoolExecutor(max_workers=1) as pool:
            pool.submit(work, obs.current()).result()
    spans = _by_name(t)
    assert spans["leaf"]["parent_id"] == root.span_id
    assert spans["twig"]["attrs"]["gc_n"] == 1
    assert spans["twig"]["tid"] != spans["root"]["tid"]
    for name in ("root", "leaf"):
        assert "gc_n" not in spans[name]["attrs"]
    assert t.gc_unattributed_n == 1


def test_every_collection_is_charged_once_and_the_hook_takes_no_lock():
    """With a collection after every allocation, some start inside
    ``Tracer._finish`` with its lock held: the hook must not wait for it,
    and each pause lands on exactly one span or on the tracer."""
    t = obs.enable(obs.Tracer())
    seen = []

    def count(phase, info):
        if phase == "stop":
            seen.append(1)

    before = t.gc_unattributed_n
    threshold = gc.get_threshold()
    gc.callbacks.append(count)
    gc.set_threshold(1)
    try:
        for i in range(40):
            with obs.span("a", i=i):
                with obs.span("b"):
                    [object() for _ in range(4)]
    finally:
        gc.callbacks.remove(count)
        unattributed = t.gc_unattributed_n - before
        gc.set_threshold(*threshold)
    charged = sum(s["attrs"].get("gc_n", 0) for s in t.spans())
    assert len(t.spans()) == 80 and seen
    assert charged + unattributed == len(seen)


# ------------------------------------------------------------ the hook
def test_the_hook_is_installed_once_and_only_while_tracing():
    before = list(gc.callbacks)
    with obs.span("off"):
        obs.current()
        with obs.attach(None):
            gc.collect()
    assert gc.callbacks == before            # tracing off: no hook
    obs.enable()
    obs.enable()
    obs.enable(obs.Tracer())                 # a new tracer, the same hook
    assert len(gc.callbacks) == len(before) + 1

    def probe(phase, info):
        pass

    gc.callbacks.append(probe)               # another party's hook
    obs.disable()
    assert gc.callbacks == before + [probe]
    gc.callbacks.remove(probe)
    obs.disable()
    assert gc.callbacks == before


def test_trace_context_is_still_two_strings_and_pickles():
    obs.enable(obs.Tracer())
    with obs.span("a"):
        ctx = obs.current()
    assert [f.name for f in dataclasses.fields(ctx)] == ["trace_id",
                                                         "span_id"]
    assert all(isinstance(getattr(ctx, f), str)
               for f in ("trace_id", "span_id"))
    assert pickle.loads(pickle.dumps(ctx)) == ctx


# ------------------------------------------------------------- exports
def test_exports_carry_thread_time_and_pauses(manual_gc):
    t = obs.enable(obs.Tracer())
    with obs.span("a", cat="x"):
        gc.collect()
    (rec,) = t.spans()
    chrome, nd = io.StringIO(), io.StringIO()
    obs.export_chrome(t.spans(), (), chrome)
    obs.export_ndjson(t.spans(), nd)
    (x,) = [e for e in json.loads(chrome.getvalue())["traceEvents"]
            if e["ph"] == "X"]
    assert x["tdur"] == pytest.approx(rec["cpu_ns"] / 1000.0)
    assert x["args"]["gc_n"] == 1 and x["args"]["gc_ns"] > 0
    line = json.loads(nd.getvalue())
    assert line["cpu_ns"] == rec["cpu_ns"]
    assert line["attrs"]["gc_n"] == 1
    assert line["attrs"]["gc_ns"] == rec["attrs"]["gc_ns"]
    # a span recorded without cpu_ns exports as before: no tdur
    old = {k: v for k, v in rec.items() if k != "cpu_ns"}
    chrome = io.StringIO()
    obs.export_chrome([old], (), chrome)
    (x,) = [e for e in json.loads(chrome.getvalue())["traceEvents"]
            if e["ph"] == "X"]
    assert "tdur" not in x


# ------------------------------------------- Algorithm 1 and pricing
#: each inner span, its parent and the category both carry
NESTING = {"select.candidates": ("cache.select", "select"),
           "select.place": ("select.candidates", "select"),
           "price.baseline": ("backend.price", "price"),
           "price.cim": ("backend.price", "price"),
           "price.macr": ("backend.price", "price")}


def _two_programs():
    return SweepSpace(workloads=("NB", "SVM"), caches=("32K+256K",))


def test_a_traced_sweep_opens_the_inner_spans_nested():
    space = _two_programs()
    t = obs.enable(obs.Tracer())
    traced = DSEEngine(device="cpu", max_workers=2).run(space)
    obs.disable()
    plain = DSEEngine(device="cpu", max_workers=2).run(space)
    assert traced.records == plain.records

    spans = t.spans()
    by_id = {s["span_id"]: s for s in spans}
    assert all("cpu_ns" in s for s in spans)
    n_points = len(plain.records)
    for name, (parent, cat) in NESTING.items():
        mine = [s for s in spans if s["name"] == name]
        assert mine, name
        for s in mine:
            up = by_id[s["parent_id"]]
            assert up["name"] == parent and s["cat"] == up["cat"] == cat
    counts = {name: sum(s["name"] == name for s in spans) for name in NESTING}
    assert counts["select.candidates"] == counts["select.place"] == 2
    assert counts["price.baseline"] == counts["price.cim"] == \
        counts["price.macr"] == n_points
    for s in spans:
        a = s["attrs"]
        if s["name"] == "select.place":
            assert a["n_protos"] > 0
        elif s["name"] == "select.candidates":
            assert a["n_candidates"] >= 0
        elif s["name"] == "price.cim":
            assert a["n_groups"] >= 0
