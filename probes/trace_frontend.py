#!/usr/bin/env python3
"""Time the trace frontend and what it costs the runner, parent against
change, on one card.

    python3 probes/trace_frontend.py [--parent DIR] [--out FILE]

For this checkout (and, with ``--parent``, a checkout of the parent
commit, the two timed in turns: parent, change, change, parent), each in
its own fresh Python process on the card, with the kernels built first:

  * ``trace``  -- the 17 Table-IV workloads built and traced on the VM
    (``trace_structural``, columns on the card), host seconds each and in
    all; a tree without the VM loads its committed fixtures instead
    (``fixtures.load_structural``), timed the same way;
  * ``bench``  -- a cold ``python -m repro_torch.bench --device cuda``
    (all ten artifacts into a temporary directory), wall seconds of the
    whole process, and whether every artifact is byte-identical to the
    committed reference artifact;
  * ``process`` -- fig14's space under ``DSEEngine(executor="process",
    max_workers=2)`` with a fresh store, seconds of ``run`` (the workers'
    start included), and whether its records equal the reference's.

Everything goes to ``chiprun_out/trace_frontend.json``.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BUILD = """
from repro_torch.core.accel import _build
_build.build(list(_build.sources().values()))
"""

_TRACE = """
import json, time, torch
from repro_torch.workloads import fixtures
try:
    from repro_torch.core.trace import trace_structural
    from repro_torch.workloads import build
except ImportError:                      # a tree without the trace VM
    build = None
dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)
per = {}
t_all = time.perf_counter()
for name in fixtures.WORKLOADS:
    t0 = time.perf_counter()
    if build is None:
        st = fixtures.load_structural(name, device=dev)
    else:
        st = trace_structural(*build(name)[:1], *build(name)[1], device=dev)
    torch.cuda.synchronize()
    per[name] = [time.perf_counter() - t0, st.n_instructions]
total = time.perf_counter() - t_all
print(json.dumps({"source": "fixtures" if build is None else "vm",
                  "total_s": total, "per_workload": per}))
"""

_PROCESS = """
import json, tempfile, time
from repro_torch.bench import run as bench_run
from repro_torch.dse import DSEEngine
from repro_torch.workloads import fixtures
space = bench_run.ALL["fig14"].space()
with tempfile.TemporaryDirectory() as d:
    eng = DSEEngine(executor="process", max_workers=2, store=d,
                    device="cuda")
    t0 = time.perf_counter()
    res = eng.run(space)
    secs = time.perf_counter() - t0
print(json.dumps({"process_s": secs, "stats": res.stats,
                  "equal": [r.to_dict() for r in res]
                  == fixtures.reference_records()["fig14"]}))
"""


def run_py(tree: pathlib.Path, code=None, args=(), timeout=900):
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    cmd = [sys.executable, *(("-c", code) if code else ()), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {cmd[:3]} failed:\n{proc.stderr[-3000:]}")
    return proc.stdout, wall


def measure(tree: pathlib.Path) -> dict:
    out, _ = run_py(tree, _TRACE)
    trace = json.loads(out.strip().splitlines()[-1])
    with tempfile.TemporaryDirectory() as d:
        _, wall = run_py(tree, args=("-m", "repro_torch.bench", "--device",
                                     "cuda", "--out", d))
        ref = tree / "src/repro_torch/workloads/fixtures/reference_artifacts"
        names = sorted(p.name for p in ref.iterdir()
                       if p.suffix in (".csv", ".json")
                       and p.name != "records.json")
        same = all((pathlib.Path(d) / n).read_bytes() == (ref / n).read_bytes()
                   for n in names)
    out, _ = run_py(tree, _PROCESS)
    proc = json.loads(out.strip().splitlines()[-1])
    return dict(trace=trace, bench_s=wall, bench_identical=same,
                bench_files=len(names), **proc)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a checkout of the parent commit")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "chiprun_out" / "trace_frontend.json")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    trees = {"change": ROOT}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    for name, tree in trees.items():
        run_py(tree, _BUILD)
    order = (["parent", "change", "change", "parent"]
             if "parent" in trees else ["change", "change"])
    runs = []
    for name in order:
        m = measure(trees[name])
        runs.append(dict(tree=name, **m))
        print(f"{name:6s} trace ({m['trace']['source']}) "
              f"{m['trace']['total_s']:.3f} s; cold bench {m['bench_s']:.3f}"
              f" s, {m['bench_files']} artifacts identical "
              f"{m['bench_identical']}; process executor "
              f"{m['process_s']:.3f} s, records equal {m['equal']}",
              flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, runs=runs), indent=1))
    print(smi, flush=True)
    ok = all(r["bench_identical"] and r["equal"] for r in runs)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
