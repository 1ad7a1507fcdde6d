"""Whole runs of every cell of ``cimbench/pending.json`` (the benchmark's
and those not admitted yet) on the CPU at a small size (two programs;
KM@16 for the sampled cell), each in a process of its own: the check
passes the sound run and fails its float32 control and every fault of
the timed path; no run loads JAX or the original package; a cell, mix
and metric added as files are found by name; and the command refuses to
run without a card."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from cimbench.tests.cimbench_tiny import FAULTS, make_root

ROOT = pathlib.Path(__file__).resolve().parents[2]
#: the benchmark's cells and those not admitted yet
CELLS = [c["name"] for c in json.loads(
    (ROOT / "cimbench" / "pending.json").read_text())["workloads"]]
#: one point per request: no batch to halve
NOT_A_FAULT_OF = {("exact-points", "half")}


def tiny(root, cells, faults=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    argv = [sys.executable, "-m", "cimbench.tests.cimbench_tiny", str(root),
            ",".join(cells)] + ([",".join(faults)] if faults else [])
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("cimbench"))
    return {(r["cell"], r["fault"]): r for r in tiny(root, CELLS)}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_its_control_is_not(runs, cell):
    r = runs[(cell, "none")]
    assert r["correct"] and r["failed"] == 0
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    # the reference in float32 in the program's place: some price moves
    assert 0 < r["control"]["record_gap"] < 1e-2


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS if (c, f) not in NOT_A_FAULT_OF])
def test_each_fault_of_the_timed_path_is_caught(runs, cell, fault):
    assert not runs[(cell, fault)]["correct"]


def test_no_run_loads_jax_or_the_original_package(runs):
    assert all(r["forbidden"] == [] for r in runs.values())


def test_a_cell_mix_and_metric_added_as_files_are_found(tmp_path):
    root = make_root(tmp_path)
    home = root / "cimbench"
    cfg = json.loads((home / "configs" / "table4-exact.json").read_text())
    cfg.update(name="table4-two", workloads=["DT", "LiR"])
    (home / "configs" / "table4-two.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / "exact-points.json").read_text())
    mix["techs"] = ["fefet"]
    (home / "traffic" / "fefet-points.json").write_text(json.dumps(mix))
    (home / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append(dict(doc["configs"][0], name="table4-two",
                               file="cimbench/configs/table4-two.json"))
    doc["workloads"].append({"name": "two-fefet", "config": "table4-two",
                             "traffic": "fefet-points", "chips": 1,
                             "why": "added as files"})
    doc["end_to_end"].append({"name": "requests_done", "unit": "requests",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["two-fefet"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    (r,) = tiny(root, ["two-fefet"], ["none"])
    assert r["correct"] and r["metrics"]["requests_done"]["value"] > 0
    assert set(r["metrics"]) == {"requests_done", "setup_s"}


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text()
                      )["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "cimbench/run.py", "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr
