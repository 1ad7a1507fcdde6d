"""``BENCHMARK.json`` and the files it names: each configuration, mix and
metric is found by its name, so a new one is new files plus new entries.

* a configuration: its entry's ``file`` (``cimbench/configs/<name>.json``);
* a traffic mix: ``cimbench/traffic/<mix>.json``;
* a metric, end-to-end or per-layer: ``cimbench/metrics/<name>.py``, a
  module with ``read(run) -> float | None`` (``run`` is a
  :class:`cimbench.bench.RunView`).

``cimbench/pending.json`` is ``BENCHMARK.json`` as it would stand with
the cells that were built and proved correct but whose runs spread wider
than a bound can hold (``PERF.md`` gives their readings): the CPU tests
run them as they run the benchmark's own, and a cell is admitted by
copying its entries into ``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


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
