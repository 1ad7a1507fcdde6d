"""The readers of Algorithm 1's and pricing's inner spans, of pricing's
time off the CPU and of the collector's pauses, on spans built by hand:
their arithmetic, and ``None`` (never 0) for spans that carry no
``cpu_ns``, as a tracer without these readings records them; and every
per-layer entry of BENCHMARK.json beside its reader, its layer and the
cells that report what it moves."""
import pathlib

import pytest

from cimbench.bench import RunView
from cimbench.manifest import Manifest

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAN = Manifest(ROOT)
MS = 1_000_000
READERS = ("partition_ms.sweep", "place_ms.sweep", "price_baseline_ms.sweep",
           "price_cim_ms.sweep", "price_macr_ms.sweep",
           "price_wait_ms.sweep", "gc_ms.sweep")


def span(sid, parent, name, dur, cpu=None, **attrs):
    s = {"span_id": sid, "parent_id": parent, "name": name, "cat": "x",
         "dur_ns": dur, "ts_ns": 0, "attrs": attrs}
    if cpu is not None:
        s["cpu_ns"] = cpu
    return s


def window(cpu=True):
    """Two design points: two selections, each a tree extraction around
    a placement, and two pricings of three parts each."""
    c = (lambda x: x) if cpu else (lambda x: None)
    return [
        span("s1", None, "cache.select", 30 * MS, c(29 * MS)),
        span("c1", "s1", "select.candidates", 24 * MS, c(24 * MS),
             gc_n=1, gc_ns=2 * MS),
        span("p1", "c1", "select.place", 10 * MS, c(9 * MS)),
        span("s2", None, "cache.select", 10 * MS, c(10 * MS)),
        span("c2", "s2", "select.candidates", 8 * MS, c(8 * MS)),
        span("p2", "c2", "select.place", 2 * MS, c(2 * MS),
             gc_n=2, gc_ns=MS),
        span("b1", None, "backend.price", 9 * MS, c(5 * MS)),
        span("b1a", "b1", "price.baseline", 2 * MS, c(MS)),
        span("b1b", "b1", "price.cim", 3 * MS, c(2 * MS),
             gc_n=1, gc_ns=500_000),
        span("b1c", "b1", "price.macr", 3 * MS, c(2 * MS)),
        span("b2", None, "backend.price", 7 * MS, c(6 * MS)),
        span("b2a", "b2", "price.baseline", 2 * MS, c(2 * MS)),
        span("b2b", "b2", "price.cim", 1 * MS, c(MS)),
        span("b2c", "b2", "price.macr", 3 * MS, c(3 * MS)),
    ]


def view(spans, points=2):
    return RunView(units=[{"points": [0] * points, "seconds": 1.0}],
                   window_s=1.0, setup_s=1.0, spans=spans)


@pytest.mark.parametrize("name,want", [
    ("partition_ms.sweep", ((24 - 10) + (8 - 2)) / 2),
    ("place_ms.sweep", (10 + 2) / 2),
    ("price_baseline_ms.sweep", (2 + 2) / 2),
    ("price_cim_ms.sweep", (3 + 1) / 2),
    ("price_macr_ms.sweep", (3 + 3) / 2),
    ("price_wait_ms.sweep", ((9 - 5) + (7 - 6)) / 2),
    ("gc_ms.sweep", (2 + 1 + 0.5) / 2),
])
def test_reader_arithmetic(name, want):
    assert MAN.reader(name)(view(window())) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_cpu_ns(name):
    read = MAN.reader(name)
    assert read(view(window(cpu=False))) is None
    assert read(view([])) is None
    assert read(view(None)) is None
    assert read(view(window(), points=0)) is None


def test_the_parts_stay_within_their_layers():
    run = view(window())
    select = (30 + 10) / 2
    price = (9 + 7) / 2
    parts = [MAN.reader(n)(run) for n in READERS]
    assert parts[0] + parts[1] <= select
    assert sum(parts[2:5]) <= price


LAYERS = {"partition_ms.sweep": "Algorithm 1",
          "place_ms.sweep": "Algorithm 1", "gc_ms.sweep": "collector"}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_has_its_entry(name):
    entry = next(m for m in MAN.doc["per_layer"] if m["name"] == name)
    assert entry["unit"] == "ms/point" and entry["better"] == "lower"
    assert entry["source"] == "program_span"
    assert entry["moves"] == "points_per_s"
    assert entry["layer"] == LAYERS.get(name, "pricing")


@pytest.mark.parametrize("entry", MAN.doc["per_layer"],
                         ids=[m["name"] for m in MAN.doc["per_layer"]])
def test_per_layer_entry_fits_the_benchmark(entry):
    """The entry's reader is there, its layer is spelt as every other
    metric of that layer spells it, and every cell it lists reports the
    end-to-end metric it moves."""
    doc = MAN.doc
    assert (ROOT / "cimbench" / "metrics" / f"{entry['name']}.py").is_file()
    assert {m["layer"] for m in doc["per_layer"]
            if m["layer"].lower() == entry["layer"].lower()} == \
        {entry["layer"]}
    moves = next(m for m in doc["end_to_end"] if m["name"] == entry["moves"])
    cells = {c["name"] for c in doc["workloads"]}
    assert entry["workloads"]
    assert set(entry["workloads"]) <= set(moves.get("workloads", cells))
