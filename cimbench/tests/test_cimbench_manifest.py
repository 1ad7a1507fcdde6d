"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the files each entry names, and the run-time budget; and
``cimbench/pending.json`` (BENCHMARK.json with the cells not admitted
yet) against the same contract, and against BENCHMARK.json."""
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
DOCS = {"BENCHMARK.json": json.loads((ROOT / "BENCHMARK.json").read_text()),
        "pending.json": json.loads((ROOT / "cimbench" / "pending.json")
                                   .read_text())}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def entries(group):
    return [pytest.param(doc, x, id=f"{name}:{x['name']}")
            for name, doc in DOCS.items() for x in doc[group]]


def e2e(doc):
    return {m["name"]: m for m in doc["end_to_end"]}


def cells(doc):
    return {c["name"]: c for c in doc["workloads"]}


def reports(metric, cell):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("doc", DOCS.values(), ids=list(DOCS))
def test_top_level_keys_and_paths(doc):
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["command"] == ["python3", "cimbench/run.py"]
    assert doc["paths"] == ["cimbench"]
    assert (ROOT / "cimbench" / "run.py").is_file()
    assert len(json.dumps(doc)) <= 64 * 1024


@pytest.mark.parametrize("doc", DOCS.values(), ids=list(DOCS))
def test_run_seconds_fit_the_budget_with_every_cell(doc):
    rs = doc["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("doc,cfg", entries("configs"))
def test_config_entry_and_file(doc, cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and TEXT.match(cfg["source"])
    assert TEXT.match(cfg["why"]) and len(cfg["reduced"]) <= 16
    assert cfg["file"].startswith("cimbench/configs/")
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in body
    assert any(c["config"] == cfg["name"] for c in doc["workloads"])


@pytest.mark.parametrize("doc,cell", entries("workloads"))
def test_cell_entry_reports_what_it_must(doc, cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert TEXT.match(cell["why"]) and cell["chips"] == 1
    assert cell["config"] in {c["name"] for c in doc["configs"]}
    assert (ROOT / "cimbench" / "traffic" / f"{cell['traffic']}.json"
            ).is_file()
    names = [m["name"] for m in doc["end_to_end"]
             if reports(m, cell["name"])]
    assert "setup_s" in names and len(names) >= 2
    assert any(reports(m, cell["name"]) for m in doc["per_layer"])


@pytest.mark.parametrize("doc", DOCS.values(), ids=list(DOCS))
def test_names_are_unique(doc):
    pairs = [(c["config"], c["traffic"]) for c in doc["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in doc[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("doc,m", entries("end_to_end"))
def test_end_to_end_metric(doc, m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", [])) <= set(cells(doc))
    assert (ROOT / "cimbench" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("doc,m", entries("per_layer"))
def test_per_layer_metric(doc, m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert TEXT.match(m["layer"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert m["moves"] in e2e(doc)
    for cell in m["workloads"]:
        assert cell in cells(doc) and reports(e2e(doc)[m["moves"]], cell)
    if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
        assert m["unit"] == "%"
    assert (ROOT / "cimbench" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("doc", DOCS.values(), ids=list(DOCS))
def test_setup_bound_and_layers_named_alike(doc):
    assert e2e(doc)["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e(doc)["setup_s"]
    layers = {m["layer"] for m in doc["per_layer"]}
    assert len({name.lower() for name in layers}) == len(layers)


def test_pending_holds_the_benchmark_as_it_stands():
    """An entry of BENCHMARK.json stands in pending.json as it is, but
    for the cells it lists (pending.json's may list more)."""
    bench, pending = DOCS["BENCHMARK.json"], DOCS["pending.json"]
    for key in ("command", "paths", "run_seconds"):
        assert bench[key] == pending[key]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        theirs = {x["name"]: x for x in pending[group]}
        for x in bench[group]:
            other = theirs[x["name"]]
            assert {k: v for k, v in x.items() if k != "workloads"} == \
                {k: v for k, v in other.items() if k != "workloads"}
            assert set(x.get("workloads", [])) <= \
                set(other.get("workloads", []))
