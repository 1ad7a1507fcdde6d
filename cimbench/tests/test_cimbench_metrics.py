"""The yardstick's arithmetic and the readers on runs built by hand: self
time, a tail over every request, a rate over whole units, K1's roofline
share, the device's idle share and whom it waited for."""
import importlib.util
import pathlib
import statistics

import pytest

from cimbench import yardstick
from cimbench.bench import RunView
from cimbench.devtrace import DeviceTrace
from cimbench.manifest import Manifest

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAN = Manifest(ROOT)


def read(name, run):
    return MAN.reader(name)(run)


def span(sid, parent, dur, cat, name="s", ts=0, **attrs):
    return {"span_id": sid, "parent_id": parent, "dur_ns": dur, "cat": cat,
            "name": name, "ts_ns": ts, "attrs": attrs}


def view(units, window_s=10.0, spans=None, device=None, k1=None):
    run = RunView(units=units, window_s=window_s, setup_s=3.5, spans=spans,
                  device=device)
    run.k1_launches = k1            # the CiM kind's traced field
    return run


def test_self_time_subtracts_children_and_clamps():
    spans = [span("a", None, 10_000_000_000, "engine"),
             span("b", "a", 4_000_000_000, "select"),
             span("c", "b", 1_000_000_000, "price"),
             span("d", "a", 9_000_000_000, "trace")]   # overlaps b
    got = yardstick.self_time_by_cat(spans)
    assert got == {"engine": 0.0, "select": 3.0, "price": 1.0, "trace": 9.0}


def test_per_point_self_time_reader():
    spans = [span("a", None, 3_000_000_000, "select"),
             span("b", None, 600_000_000, "replay")]
    run = view([{"points": [0] * 100, "seconds": 1.0}], spans=spans)
    assert read("select_ms.sweep", run) == pytest.approx(30.0)
    assert read("replay_ms.point", run) == pytest.approx(6.0)
    assert read("select_ms.sweep", view(run.units)) is None


def test_sampled_span_seconds_are_per_analysis():
    spans = [span("a", None, 12_000_000_000, "sampling",
                  name="sampling.select"),
             span("b", None, 3_000_000_000, "sampling",
                  name="sampling.windows")]
    run = view([{"points": [0] * 6, "seconds": 70.0}], spans=spans)
    assert read("select_s.sampled", run) == pytest.approx(2.0)
    assert read("windows_s.sampled", run) == pytest.approx(0.5)


def test_rate_is_every_point_over_the_whole_window():
    units = [{"points": [0] * 306, "seconds": 9.0},
             {"points": [0] * 306, "seconds": 12.5}]
    assert read("points_per_s", view(units, window_s=21.6)) == \
        pytest.approx(612 / 21.6)


def test_tail_is_over_every_request():
    lat = [0.001 * (i + 1) for i in range(400)]
    units = [{"points": [0], "seconds": x} for x in lat]
    want = statistics.quantiles(lat, n=20, method="inclusive")[-1] * 1e3
    assert read("point_p95_ms", view(units)) == pytest.approx(want)
    assert 379 < want < 381


def test_sampled_rate_counts_virtual_instructions():
    units = [{"points": [0], "seconds": 9.0, "work": 7_589_808}] * 3
    assert read("sampled_minst_per_s", view(units, window_s=30.0)) == \
        pytest.approx(3 * 7.589808 / 30.0)
    assert read("setup_s", view(units)) == 3.5


def fake_device(events, start=0, end=10_000_000_000):
    dt = DeviceTrace("cpu")
    dt.events, dt.start_ns, dt.end_ns = events, start, end
    return dt


def test_union_gaps_and_idle_share():
    ev = [("k", 0, 2_000_000_000), ("k", 1_000_000_000, 3_000_000_000),
          ("m", 5_000_000_000, 6_000_000_000)]
    dt = fake_device(ev)
    assert dt.busy_s == pytest.approx(4.0)
    assert yardstick.gaps([(0, 3), (5, 6)], 0, 10) == [(3, 5), (6, 10)]
    assert read("device_idle.sweep", view([], device=dt)) == \
        pytest.approx(0.6)
    assert read("device_idle.point", view([])) is None


def test_idle_is_named_by_the_innermost_open_span():
    dt = fake_device([("k", 0, 2_000_000_000),
                      ("k", 7_500_000_000, 8_000_000_000)])
    spans = [span("a", None, 10_000_000_000, "engine", name="dse.run",
                  ts=100),
             span("b", "a", 3_000_000_000, "select", name="cache.select",
                  ts=100 + 4_000_000_000)]
    got = dict(dt.idle_by_host(spans, epoch_ns=100))
    # each idle stretch goes to the span open at its midpoint
    assert got == {"cache.select": pytest.approx(5.5),
                   "dse.run": pytest.approx(2.0)}


def test_k1_roofline_is_bytes_bound_over_device_time():
    ev = [("replay_kernel<2>", 0, 1_000_000), ("other", 0, 5_000_000),
          ("replay_kernel<2>", 2_000_000, 3_000_000)]
    dt = fake_device(ev)
    k1 = [(30_000, 3), (10_000, 1)]
    bound_ms = (30_000 * (9 + 15) + 10_000 * (9 + 5)) / 3.35e12 * 1e3
    want = 100 * bound_ms / 2.0
    assert read("k1_roofline.sweep", view([], device=dt, k1=k1)) == \
        pytest.approx(want)
    # launches the trace does not show cannot be priced
    assert read("k1_roofline.sampled", view([], device=dt, k1=k1[:1])) \
        is None


def test_every_metric_has_a_reader():
    doc = MAN.doc
    for m in doc["end_to_end"] + doc["per_layer"]:
        path = ROOT / "cimbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read)


def test_a_window_holds_the_engines_of_a_drawn_unit_and_the_last():
    import random
    from cimbench.bench import keep_two
    from cimbench.port import Port
    drawn = set()
    for seed in range(200):
        draw, held, units = random.Random(seed), None, []
        for n in range(12):
            units.append({"out": {"engines": [n]}})
            held = keep_two(units, held, draw, Port.release)
            kept = {i for i, u in enumerate(units) if u["out"]["engines"]}
            assert kept == {held, n}
        drawn.add(held)
    # the held unit comes from anywhere in the window, not its start
    assert drawn == set(range(12))


def test_collector_pauses_name_the_idle_stretches_they_fall_in():
    from cimbench.bench import GcPause
    pause = GcPause()
    pause.close()
    pause.pauses = [(4_000_000_000, 6_000_000_000)]
    spans = [span("a", None, 10_000_000_000, "engine", name="dse.run")]
    dt = fake_device([("k", 0, 1_000_000_000),
                      ("k", 3_900_000_000, 4_000_000_000),
                      ("k", 6_000_000_000, 6_100_000_000)])
    idle = dict(dt.idle_by_host(spans + pause.spans(0), 0))
    assert idle == {"(garbage collection)": pytest.approx(2.0),
                    "dse.run": pytest.approx(2.9 + 3.9)}
