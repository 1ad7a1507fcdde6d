"""``BENCHMARK.json`` and the files it names: each configuration, kind,
mix and metric is found by its name, so a new one is new files plus new
entries.

* a configuration: its entry's ``file`` (``cimbench/configs/<name>.json``),
  whose optional ``"kind"`` (``"cim"`` where absent) names the module
  ``cimbench/kinds/<kind>.py`` that builds, drives and checks it;
* a traffic mix: ``cimbench/traffic/<mix>.json``, read by its cell's kind;
* a metric, end-to-end or per-layer: ``cimbench/metrics/<name>.py``, a
  module with ``read(run) -> float | None`` (``run`` is a
  :class:`cimbench.bench.RunView`).

A run reads ``BENCHMARK.json`` alone.  ``cimbench/pending.json`` holds
only the entries that wait for admission (cells built and proved correct
whose runs spread wider than a bound can hold, and the configurations and
metrics only they use; ``PERF.md`` gives their readings), under the same
four groups, and never a name that ``BENCHMARK.json`` has.  A pending
cell that would report metrics ``BENCHMARK.json`` already lists names
them in its entry's ``"reports"``.  :func:`union` is what the CPU tests
run.  A cell is admitted by moving its entries from ``pending.json`` to
``BENCHMARK.json``, less ``"reports"``, and adding its name to the
``workloads`` of each metric that ``"reports"`` named.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: the groups of entries, each a list of objects with a ``name``
GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


def union(root=ROOT) -> Dict:
    """``BENCHMARK.json`` with ``cimbench/pending.json``'s entries after
    its own, group by group, and each pending cell in the ``workloads``
    of the metrics its ``"reports"`` names (the key itself dropped)."""
    root = pathlib.Path(root)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    pending = json.loads((root / "cimbench" / "pending.json").read_text())
    out = dict(doc, **{g: doc[g] + pending.get(g, []) for g in GROUPS})
    reported: Dict[str, List[str]] = {}
    cells = []
    for cell in out["workloads"]:
        cell = dict(cell)
        for metric in cell.pop("reports", []):
            reported.setdefault(metric, []).append(cell["name"])
        cells.append(cell)
    out["workloads"] = cells
    for g in ("end_to_end", "per_layer"):
        out[g] = [dict(m, workloads=m["workloads"] + reported[m["name"]])
                  if m["name"] in reported else m for m in out[g]]
    return out


class Manifest:
    def __init__(self, root=ROOT):
        self.root = pathlib.Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.home = self.root / "cimbench"

    def cell(self, name: str) -> Dict:
        for c in self.doc["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[c['name'] for c in self.doc['workloads']]}")

    def config(self, name: str) -> Dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic_path(self, mix: str) -> pathlib.Path:
        return self.home / "traffic" / f"{mix}.json"

    def metrics(self, cell: str, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics ``cell`` reports: a
        metric with ``workloads`` in the cells it lists, one without in
        every cell."""
        return [m for m in self.doc[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"cimbench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
