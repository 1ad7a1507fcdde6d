"""A small copy of the benchmark for the CPU tests, and the faults the
check has to catch.

:func:`make_root` writes a checkout-shaped directory whose
``BENCHMARK.json`` is the union of ``BENCHMARK.json`` and
``cimbench/pending.json`` (the benchmark's cells and those not admitted
yet), and whose configurations, mixes and metric readers are the real
ones, cut by each configuration's kind (``tiny_config``, ``tiny_mix``) to
sizes a CPU runs in seconds: for the CiM kind two Table-IV programs, and
KM@16 with 4096-instruction windows for the sampled cell.  Run as a
module, it runs cells there on the CPU, each sound (with the kind's
control) and under each fault its kind plants, and prints one JSON line
per run:

    python -m cimbench.tests.cimbench_tiny ROOT CELL[,CELL...] \
        [FAULT[,FAULT...]]

("none" is the sound run; the default is it and every fault of the
cell's kind.)
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

from cimbench import kinds
from cimbench.manifest import Manifest, union

HOME = pathlib.Path(__file__).resolve().parents[1]
ROOT = HOME.parent
SECONDS = 1.0


def make_root(dest: pathlib.Path) -> pathlib.Path:
    """A root at ``dest`` for the tiny runs; returns it."""
    dest = pathlib.Path(dest)
    (dest / "cimbench").mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "configs", "traffic"):
        shutil.copytree(HOME / d, dest / "cimbench" / d, dirs_exist_ok=True)
    doc = union(ROOT)
    (dest / "BENCHMARK.json").write_text(json.dumps(doc))
    kind_of = {}
    for entry in doc["configs"]:
        path = dest / entry["file"]
        cfg = json.loads(path.read_text())
        kind_of[entry["name"]] = kind = kinds.of(cfg)
        path.write_text(json.dumps(kind.tiny_config(cfg)))
    mixes = {c["traffic"]: kind_of[c["config"]] for c in doc["workloads"]}
    for mix, kind in mixes.items():
        path = dest / "cimbench" / "traffic" / f"{mix}.json"
        path.write_text(json.dumps(kind.tiny_mix(json.loads(
            path.read_text()))))
    return dest


def main(argv) -> int:
    root, cells = pathlib.Path(argv[0]), argv[1].split(",")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cimbench.bench import forbidden_modules, run_cell
    man = Manifest(root)
    for cell in cells:
        kind = kinds.of(man.config(man.cell(cell)["config"]))
        faults = argv[2].split(",") if len(argv) > 2 else \
            ("none",) + kind.FAULTS
        for name in faults:
            with kind.fault(name):
                out = run_cell(cell, 20260101, SECONDS, False, root=root,
                               device="cpu", control=name == "none")
            print(json.dumps({"cell": cell, "fault": name,
                              "correct": out["correct"],
                              "metrics": out["metrics"],
                              "failed": out["failed"],
                              "checks": out["checks"],
                              "control": out.get("control"),
                              "control_passes": out.get("control_passes"),
                              "forbidden": forbidden_modules()}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
