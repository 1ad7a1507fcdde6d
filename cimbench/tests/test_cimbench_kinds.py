"""A configuration of a new kind enters the benchmark as new files plus
new entries in ``BENCHMARK.json``: in a copy of the harness, a toy kind
(``kinds/toy.py``), its configuration, mix and metric and one new cell
run through ``run_cell`` on the CPU, untraced and traced, correct when
sound and not when its answer is nudged; the harness's own CPU tests pass
in the copy; and every file the copy had before is byte for byte as it
was.  An unknown kind is refused before set-up, naming the known
kinds."""
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from cimbench import kinds
from cimbench.bench import run_cell
from cimbench.manifest import GROUPS
from cimbench.tests.cimbench_tiny import make_root

ROOT = pathlib.Path(__file__).resolve().parents[2]

TOY_KIND = '''"""A toy kind: a unit is a vector of integers drawn from the
mix and the seed; the port sums their squares with torch, the reference
with Python's integers."""
import contextlib
import itertools
import json
import pathlib
import random

import torch

LIMITS = {"sum_diff": 0}
FAULTS = ("answer",)


def build_kernels():
    return {}


class Traffic:
    def __init__(self, params, seed):
        self.params, self.seed = params, seed

    def units(self):
        rng = random.Random(f"{self.seed}:units")
        for index in itertools.count():
            xs = [rng.randrange(self.params["high"])
                  for _ in range(self.params["length"])]
            yield {"index": index, "points": [xs]}


def traffic(path, config, seed):
    return Traffic(json.loads(pathlib.Path(path).read_text()), seed)


class Port:
    def __init__(self, device):
        self.device = device

    def warm(self):
        return 0

    def run_unit(self, unit):
        x = torch.tensor(unit["points"][0], dtype=torch.int64,
                         device=self.device)
        return {"sum": int((x * x).sum())}

    def release(self, unit):
        pass

    def read_back(self, units):
        pass

    def traced_fields(self, units, spans, ref):
        return {}

    def sample(self, units, ref, seed):
        return [(u["points"][0], u["out"]["sum"]) for u in units]


def port(traffic, config, device):
    return Port(device)


def keeps_every_unit(traffic):
    return True


def reference(config):
    return lambda xs: sum(x * x for x in xs)


def compare(sample, ref):
    return {"sum_diff": sum(got != ref(xs) for xs, got in sample)}


def control(sample, ref):
    return {"sum_diff": sum(
        int((torch.tensor(xs, dtype=torch.float32) ** 2).sum()) != ref(xs)
        for xs, _ in sample)}


def tiny_config(config):
    return config


def tiny_mix(mix):
    return mix


@contextlib.contextmanager
def fault(name):
    run_unit = Port.run_unit
    if name == "answer":
        Port.run_unit = lambda self, unit: {
            "sum": run_unit(self, unit)["sum"] + 1}
    elif name != "none":
        raise ValueError(name)
    try:
        yield
    finally:
        Port.run_unit = run_unit
'''
TOY_READER = '''"""Toy units summed per second over the window (host clock)."""
from cimbench.yardstick import rate


def read(run):
    return rate(len(run.units), run.window_s)
'''
TOY_LAYER_READER = '''"""A toy unit's milliseconds on the host clock, a traced run's."""


def read(run):
    if run.spans is None or not run.units:
        return None
    return 1e3 * sum(u["seconds"] for u in run.units) / len(run.units)
'''
#: a traced run of the toy cell in the copy, its result line printed
TRACED = (
    "import json, sys\n"
    "from cimbench.bench import run_cell\n"
    "print(json.dumps(run_cell('toy-squares', 2 ** 31 + 5, 1.0, True,\n"
    "                          root=sys.argv[1], device='cpu')))\n")
#: the harness's own CPU tests run in the copy, less this module and the
#: whole runs of every cell (the toy cell's are the fixture's)
OWN_TESTS = ["cimbench/tests", "--ignore=cimbench/tests/test_cimbench_kinds.py",
             "-k", "not test_sound_run and not test_each_fault "
             "and not test_no_run_loads"]


def files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in root.rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A copy of the harness with the toy added as files and entries,
    its files as they were before, and the toy cell's sound and nudged
    runs."""
    root = tmp_path_factory.mktemp("toy")
    shutil.copytree(ROOT / "cimbench", root / "cimbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = files(root)
    home = root / "cimbench"
    added = {"kinds/toy.py": TOY_KIND,
             "metrics/squares_per_s.py": TOY_READER,
             "metrics/unit_ms.toy.py": TOY_LAYER_READER,
             "configs/toy-squares.json": json.dumps({
                 "name": "toy-squares", "kind": "toy",
                 "source": "a toy kind of the harness's tests",
                 "reduced": []}),
             "traffic/toy-squares.json": json.dumps({"length": 64,
                                                     "high": 1 << 20})}
    for rel, text in added.items():
        assert not (home / rel).exists()
        (home / rel).write_text(text)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "toy-squares",
                           "source": "a toy kind of the harness's tests",
                           "file": "cimbench/configs/toy-squares.json",
                           "reduced": [], "why": "a new kind as files"})
    doc["workloads"].append({"name": "toy-squares", "config": "toy-squares",
                             "traffic": "toy-squares", "chips": 1,
                             "why": "sums of squares of drawn integers"})
    doc["end_to_end"].append({"name": "squares_per_s", "unit": "units/s",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["toy-squares"]})
    doc["per_layer"].append({"name": "unit_ms.toy", "unit": "ms/unit",
                             "better": "lower", "source": "host_clock",
                             "layer": "toy arithmetic",
                             "moves": "squares_per_s",
                             "workloads": ["toy-squares"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1) + "\n")
    # the program beside the copy, where the harness's tests look for it
    (root / "src").symlink_to(ROOT / "src", target_is_directory=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))

    def run(*argv):
        proc = subprocess.run([sys.executable, *argv], cwd=root, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, (proc.stdout[-4000:]
                                      + proc.stderr[-4000:])
        return proc.stdout

    runs = {r["fault"]: r for r in map(json.loads, run(
        "-m", "cimbench.tests.cimbench_tiny", str(root),
        "toy-squares").splitlines())}
    runs["traced"] = json.loads(run("-c", TRACED, str(root))
                                .splitlines()[-1])
    run("-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
        *OWN_TESTS)
    return root, before, runs


def test_a_new_kind_added_as_files_runs_correct(toy):
    _, _, runs = toy
    r = runs["none"]
    assert r["correct"] and r["failed"] == 0 and r["forbidden"] == []
    assert r["checks"] == {"sum_diff": {"value": 0, "limit": 0}}
    assert set(r["metrics"]) == {"setup_s", "squares_per_s"}
    assert r["metrics"]["squares_per_s"]["value"] > 0
    # the reference in float32 in the program's place fails
    assert r["control"]["sum_diff"] > 0 and r["control_passes"] is False
    # traced: the per-layer metric of the kind's own layer
    t = runs["traced"]
    assert t["correct"] and set(t["metrics"]) == {"unit_ms.toy"}
    assert t["metrics"]["unit_ms.toy"]["value"] > 0


def test_a_nudged_answer_of_the_new_kind_is_not_correct(toy):
    _, _, runs = toy
    assert set(runs) == {"none", "answer", "traced"}
    assert not runs["answer"]["correct"]
    assert runs["answer"]["checks"]["sum_diff"]["value"] > 0


def test_no_file_of_the_harness_changed_to_add_the_kind(toy):
    root, before, _ = toy
    doc = json.loads(before.pop("BENCHMARK.json"))
    assert {rel: (root / rel).read_bytes() for rel in before} == before
    # BENCHMARK.json only gained entries, after its own
    now = json.loads((root / "BENCHMARK.json").read_text())
    for group in GROUPS:
        assert now[group][:len(doc[group])] == doc[group]
    assert {k: v for k, v in now.items() if k not in GROUPS} == \
        {k: v for k, v in doc.items() if k not in GROUPS}


def test_an_unknown_kind_is_refused_before_set_up(tmp_path):
    root = make_root(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    entry = doc["configs"][0]
    cfg = json.loads((root / entry["file"]).read_text())
    (root / entry["file"]).write_text(json.dumps(dict(cfg, kind="warp")))
    cell = next(c["name"] for c in doc["workloads"]
                if c["config"] == entry["name"])
    with pytest.raises(ValueError, match=r"unknown configuration kind "
                       r"'warp'; known kinds: "
                       + re.escape(", ".join(kinds.known())) + "$"):
        run_cell(cell, 1, 1.0, False, root=root, device="cpu")
