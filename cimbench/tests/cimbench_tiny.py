"""A small copy of the benchmark for the CPU tests, and the faults the
check has to catch.

:func:`make_root` writes a checkout-shaped directory whose
``BENCHMARK.json`` is ``cimbench/pending.json`` (the benchmark's cells and
those not admitted yet), and whose configurations, mixes and metric
readers are the real ones, cut to sizes a CPU runs in seconds: two Table-IV programs, and
KM@16 with 4096-instruction windows for the sampled cell.  Run as a
module, it runs cells there on the CPU, each sound (with the float32
control) and under each fault, and prints one JSON line per run:

    python -m cimbench.tests.cimbench_tiny ROOT CELL[,CELL...] \
        [FAULT[,FAULT...]]

("none" is the sound run; the default is it and every fault.)
"""
from __future__ import annotations

import contextlib
import json
import math
import pathlib
import shutil
import sys

HOME = pathlib.Path(__file__).resolve().parents[1]
ROOT = HOME.parent
#: the faults of a timed path: an answer altered where it is produced,
#: half of the batch left out, the replay's state never changed
FAULTS = ("answer", "half", "state")
SECONDS = 1.0


def make_root(dest: pathlib.Path) -> pathlib.Path:
    """A root at ``dest`` for the tiny runs; returns it."""
    dest = pathlib.Path(dest)
    (dest / "cimbench").mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "configs", "traffic"):
        shutil.copytree(HOME / d, dest / "cimbench" / d, dirs_exist_ok=True)
    shutil.copy(HOME / "pending.json", dest / "BENCHMARK.json")
    doc = json.loads((HOME / "ref" / "sampled_windows.json").read_text())
    km16 = doc["KM@16"]
    for cfg_path in (dest / "cimbench" / "configs").glob("*.json"):
        cfg = json.loads(cfg_path.read_text())
        if cfg.get("sampling"):
            cfg.update(workloads=["KM@16"],
                       virtual_instructions=km16["total_virtual"])
        else:
            cfg["workloads"] = ["NB", "SVM"]
        cfg_path.write_text(json.dumps(cfg))
    for mix_path in (dest / "cimbench" / "traffic").glob("*.json"):
        mix = json.loads(mix_path.read_text())
        spec = mix.get("sampling")
        if spec:
            spec.update(interval=km16["spec"]["interval"],
                        warmup=km16["spec"]["warmup"],
                        seed={"cycle": sorted(map(int, km16["seeds"]))[:2]})
            mix["warm"]["workloads"] = ["KM@4"]
            mix["warm"]["sampling"].update(interval=1024, warmup=1024)
        mix_path.write_text(json.dumps(mix))
    return dest


@contextlib.contextmanager
def fault(name: str):
    """Break the program's timed path for the duration."""
    from repro_torch.core import cache as pcache
    from repro_torch.core.sampling import pipeline as spl
    from repro_torch.dse import backends, engine
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, obj.__dict__[attr]))
        setattr(obj, attr, value)

    if name == "answer":
        from_report = backends.SweepRecord.from_report.__func__
        from_estimate = backends.CimBackend._record_from_estimate

        def nudge(rec):
            import dataclasses
            return dataclasses.replace(
                rec, speedup=math.nextafter(rec.speedup, math.inf))

        patch(backends.SweepRecord, "from_report", classmethod(
            lambda cls, *a, **k: nudge(from_report(cls, *a, **k))))
        patch(backends.CimBackend, "_record_from_estimate",
              lambda self, *a, **k: nudge(from_estimate(self, *a, **k)))
    elif name == "half":
        run = engine.DSEEngine.run
        estimate_reports = spl.estimate_reports

        def half_run(self, space):
            pts = space.points() if hasattr(space, "points") else list(space)
            return run(self, pts[:max(1, len(pts) // 2)])

        def half_mean(reports, plan, spec):
            keep = list(reports[:max(1, len(reports) // 2)])
            return estimate_reports(
                [keep[i % len(keep)] for i in range(len(reports))],
                plan, spec)

        patch(engine.DSEEngine, "run", half_run)
        patch(spl, "estimate_reports", half_mean)
    elif name == "state":
        replay = pcache.CacheHierarchy.replay

        def unchanged(self, addrs, is_writes):
            lvl, hit, bank, mshr = replay(self, addrs, is_writes)
            return lvl.clone().fill_(lvl.max() if len(lvl) else 0), \
                hit.clone().fill_(0), bank, mshr

        patch(pcache.CacheHierarchy, "replay", unchanged)
    elif name != "none":
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def main(argv) -> int:
    root, cells = pathlib.Path(argv[0]), argv[1].split(",")
    faults = argv[2].split(",") if len(argv) > 2 else ("none",) + FAULTS
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cimbench.bench import forbidden_modules, run_cell
    for cell in cells:
        for name in faults:
            with fault(name):
                out = run_cell(cell, 20260101, SECONDS, False, root=root,
                               device="cpu", control=name == "none")
            print(json.dumps({"cell": cell, "fault": name,
                              "correct": out["correct"],
                              "metrics": out["metrics"],
                              "failed": out["failed"],
                              "checks": out["checks"],
                              "control": out.get("control"),
                              "forbidden": forbidden_modules()}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
