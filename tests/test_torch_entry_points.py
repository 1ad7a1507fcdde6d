"""The port's CiM entry points against the reference's, on the CPU:
``python -m repro_torch.bench timing`` (the twin of
``benchmarks/analysis_timing.py``) and its gate, and the three examples
``examples/torch_quickstart.py``, ``torch_evaluate_workloads.py`` and
``torch_dse_cim.py``, whose printed numbers equal their reference twins'
for the same arguments (only timings, the line naming the device and the
store's own byte sizes differ)."""
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")  # CI images without torch skip the port

from benchmarks import analysis_timing as ref_timing
from repro_torch.bench import run as bench_run
from repro_torch.bench import timing
from repro_torch.workloads import fixtures

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the reference doc's keys that have no counterpart in the port
NO_COUNTERPART = {"select_jax_s", "select_jax_ips", "jax_wall_s",
                  "jax_replay_batches", "jax_wall_warm_jit_s",
                  "baseline_wall_s", "improvement_x", "baseline_bytes",
                  "shrink_x"}


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(mod, argv, workloads=None):
    """(exit code, stdout) of an example's ``main(argv)`` run in process;
    ``workloads`` narrows its loop over the Table-IV programs."""
    if workloads is not None:
        mod.WORKLOADS = tuple(workloads)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


# ------------------------------------------------------- bench timing
def test_bench_timing_doc_has_the_reference_keys(tmp_path):
    out = tmp_path / "timing.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = bench_run.main(["timing", "--device", "cpu", "--workloads",
                             "NB", "--json", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    ref = json.loads((ROOT / "benchmarks/baselines/timing_nb.json")
                     .read_text())

    def keys(d):
        return set(d) - NO_COUNTERPART

    assert keys(ref) <= set(doc)
    for section in ("machine_calibration", "totals", "cold_sweep",
                    "layer1_store"):
        assert keys(ref[section]) <= set(doc[section]), section
    assert keys(ref["stages"]["NB"]) <= set(doc["stages"]["NB"])
    assert keys(ref["totals"]["share"]) == set(doc["totals"]["share"])
    assert not NO_COUNTERPART & (set(doc["totals"]) | set(doc["cold_sweep"]))
    # the same pricing as the reference's run that recorded its baseline
    assert doc["stages"]["NB"]["energy_improvement"] == \
        ref["stages"]["NB"]["energy_improvement"]
    assert doc["stages"]["NB"]["n_instructions"] == \
        ref["stages"]["NB"]["n_instructions"]
    assert doc["cold_sweep"]["points"] == ref["cold_sweep"]["points"]
    assert doc["layer1_store"]["layer1_bytes"] > 0
    assert (doc["device"], doc["card"]) == ("cpu", None)
    assert doc["launches"] == {"replay": 0, "place": 0}
    assert doc["totals"]["dominant_stage"] in doc["totals"]["share"]
    assert timing.GATE_STAGES == ("select", "price")


def _synthetic(select_ips, price_ips, score=40.0, workloads=("NB",)):
    totals = {"select_ips": select_ips, "price_ips": price_ips,
              "select_jax_ips": select_ips}
    return {"workloads": list(workloads),
            "machine_calibration": {"score": score}, "totals": totals}


@pytest.mark.parametrize("doc, n_failures", [
    (_synthetic(4e6, 9e6), 0),                      # as the baseline
    (_synthetic(3.1e6, 9e6), 0),                    # within 25%
    (_synthetic(2e6, 9e6), 1),                      # select dropped 50%
    (_synthetic(2e6, 4e6), 2),                      # both dropped
    (_synthetic(2e6, 4.5e6, score=20.0), 0),        # a host half as fast
    (_synthetic(4e6, 9e6, workloads=("NB", "KM")), 1),
], ids=["equal", "within", "select", "both", "scaled", "workloads"])
def test_gate_keeps_the_reference_verdicts_and_messages(doc, n_failures):
    base = _synthetic(4e6, 9e6)
    got = timing.gate(doc, base)
    want = [f for f in ref_timing.gate(doc, base)
            if not f.startswith("select_jax")]
    assert got == want and len(got) == n_failures


def test_gate_refuses_a_baseline_without_calibration():
    base = _synthetic(4e6, 9e6)
    del base["machine_calibration"]["score"]
    (msg,) = timing.gate(_synthetic(4e6, 9e6), base)
    assert "no machine_calibration score" in msg


def test_committed_baseline_was_recorded_on_the_card():
    base = json.loads((ROOT / "src/repro_torch/bench/baselines/"
                       "timing_nb.json").read_text())
    assert base["workloads"] == ["NB"]
    assert base["device"].startswith("cuda") and base["card"]
    assert base["launches"]["replay"] > 0 and base["launches"]["place"] > 0
    for stage in timing.GATE_STAGES:
        assert base["totals"][f"{stage}_ips"] > 0


# ---------------------------------------------------------- examples
def test_quickstart_prints_the_reference_numbers():
    mod = _load(ROOT / "examples/torch_quickstart.py", "torch_quickstart")
    rc, out = _printed(mod, ["--device", "cpu"])
    assert rc == 0
    assert fixtures.example_lines(out) == \
        fixtures.reference_single_pass()["examples"]["quickstart"]
    assert out.splitlines()[-1].startswith("device: cpu")


@pytest.mark.parametrize("tech", fixtures.TECHS)
def test_evaluate_workloads_prints_the_reference_numbers(tech):
    mod = _load(ROOT / "examples/torch_evaluate_workloads.py",
                "torch_evaluate_workloads")
    rc, out = _printed(mod, ["--device", "cpu", "--tech", tech],
                       workloads=["KM"])
    assert rc == 0
    lines = fixtures.reference_single_pass()["examples"][
        "evaluate_workloads"][tech]
    assert fixtures.example_lines(out) == \
        [lines[0]] + [ln for ln in lines[1:] if ln.split()[0] == "KM"]


_STORE_SIZE = re.compile(r"^   store size: ")


def _comparable(text: str, tmp: str):
    """An example's (or its markdown report's) lines without timings, the
    device line and the store's own byte sizes, with the temporary
    directory named alike."""
    out = []
    for line in text.splitlines():
        if line.startswith("device:") or _STORE_SIZE.match(line):
            continue
        line = re.sub(r"\b\d+\.\d+s\b", "_s", line)
        out.append(line.replace(tmp, "<dir>"))
    return out


def _records(path: pathlib.Path):
    """A ``--json`` document without its wall time, the store's own byte
    sizes and its count of batched replays (the port batches each
    workload's geometries, as the reference does only under
    ``EVA_CIM_ACCEL=jax``)."""
    doc = json.loads(path.read_text())
    del doc["elapsed_s"]
    doc["stats"] = {k: v for k, v in doc["stats"].items()
                    if k != "replay_batches"
                    and not k.startswith("store_bytes")}
    return doc


@pytest.mark.parametrize("flags", [
    [], ["--adaptive"], ["--hosts", "A9-1GHz,inorder-1GHz"],
    ["--executor", "serial"], ["--sample", "stratified"],
], ids=["sweep", "adaptive", "hosts", "serial", "sample"])
def test_dse_cim_prints_the_reference_numbers(flags, tmp_path):
    """Same arguments, same lines, reports and records as
    ``examples/dse_cim.py`` (the reference under its numpy backend)."""
    ref_cli = _load(ROOT / "examples/dse_cim.py", "dse_cim_reference")
    port_cli = _load(ROOT / "examples/torch_dse_cim.py", "torch_dse_cim")
    outs = {}
    for who, cli, extra in (("ref", ref_cli, []),
                            ("port", port_cli, ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir()
        argv = ["--workload", "NB", "--cache-dir", str(d / "store"),
                "--report", str(d / "sweep.md"), "--json",
                str(d / "sweep.json"), *flags, *extra]
        rc, out = _printed(cli, argv)
        assert rc == 0
        outs[who] = (_comparable(out, str(d)),
                     _comparable((d / "sweep.md").read_text(), str(d)),
                     _records(d / "sweep.json"))
    assert outs["port"] == outs["ref"]


def test_dse_cim_second_run_on_a_store_builds_nothing(tmp_path):
    cli = _load(ROOT / "examples/torch_dse_cim.py", "torch_dse_cim")
    argv = ["--workload", "NB", "--device", "cpu", "--cache-dir",
            str(tmp_path)]
    outs = [_printed(cli, argv)[1] for _ in range(2)]
    assert "(trace builds 3, selection builds 9)" in outs[0]
    assert "(trace builds 0, selection builds 0)" in outs[1]
    assert "3 trace hits / 9 selection hits / 0 writes" in outs[1]


def test_dse_cim_backend_tpu_exits_2_with_one_line(tmp_path):
    """``--backend tpu`` prices the accelerator-mode space through
    ``TpuBackend`` on the device: exit 0, and every line it prints is the
    engine's record for the same space (never a CiM record)."""
    cli = _load(ROOT / "examples/torch_dse_cim.py", "torch_dse_cim")
    rc, out = _printed(cli, ["--backend", "tpu", "--workload", "xlstm-125m",
                             "--device", "cpu", "--chips", "v5e,v5p",
                             "--thresholds", "16K,1M",
                             "--json", str(tmp_path / "tpu.json")])
    assert rc == 0
    from repro_torch.dse import (DSEEngine, SweepSpace, TPU_PRESETS,
                                 TpuBackend, TpuOption)
    space = SweepSpace(workloads=("xlstm-125m",), tpus=tuple(
        TpuOption(TPU_PRESETS[c], t) for c in ("v5e", "v5p")
        for t in (1 << 14, 1 << 20)))
    want = DSEEngine(backend=TpuBackend(), device="cpu").run(space)
    front = want.pareto(("energy_improvement", "speedup"))
    lines = [
        "== xlstm-125m: 4 design points, 1 ATen-graph analysis ==",
        "   done in _s (graph analyses 1, fusion selections 2)",
        "== chip slice (threshold thr16K) =="]
    lines += [f"  {r.cache:6s} E-impr {r.energy_improvement:5.2f}x "
              f"speedup {r.speedup:5.2f}x bound {r.cim_runtime_ms:.4f}ms"
              for r in want if r.cim_set == "thr16K"]
    lines.append("== fusion-threshold slice (chip v5e) ==")
    lines += [f"  {r.cim_set:8s} tpu_macr {r.macr:.3f} "
              f"E-impr {r.energy_improvement:5.2f}x "
              f"speedup {r.speedup:5.2f}x" for r in want if r.cache == "v5e"]
    lines.append("== Pareto frontier (energy improvement vs speedup) ==")
    lines += [f"  {r.workload}/{r.cache}/{r.cim_set:8s} "
              f"E {r.energy_improvement:5.2f}x spd {r.speedup:5.2f}x"
              for r in front]
    lines.append("[json] <dir>/tpu.json")
    assert _comparable(out, str(tmp_path)) == lines
    assert _records(tmp_path / "tpu.json")["records"] == \
        [r.to_dict() for r in want]
    assert all(r.backend == "tpu" and r.tech == "tpu" for r in want)


def test_dse_cim_clear_error_on_newer_store(tmp_path, capsys):
    """Twin of ``tests/test_store.py``'s CLI case: exit 2 with a one-line
    error (no traceback) when --cache-dir holds a newer-format store."""
    cli = _load(ROOT / "examples/torch_dse_cim.py", "torch_dse_cim")
    (tmp_path / "FORMAT.json").write_text(json.dumps({"store_format": 99}))
    rc = cli.main(["--workload", "NB", "--device", "cpu", "--cache-dir",
                   str(tmp_path)])
    err = capsys.readouterr().err
    assert rc == 2
    assert "STORE_FORMAT=99" in err
    assert "Traceback" not in err
    assert len(err.strip().splitlines()) == 1


def test_dse_cim_writes_valid_trace_and_report(tmp_path):
    """Twin of ``tests/test_obs.py``'s example case: a cold --trace run
    writes a Perfetto-loadable file and the --trace-report attribution
    sums to within 5% of the wall clock."""
    trace = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "examples/torch_dse_cim.py", "--workload", "NB",
         "--device", "cpu", "--trace", str(trace), "--trace-report"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(trace.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert xs and all(e["args"].get("trace_id") for e in xs)
    assert "| stage |" in proc.stdout
    footer = proc.stdout.strip().splitlines()[-1]
    m = re.search(r"\((\d+(?:\.\d+)?)%\)$", footer)
    assert m, footer
    assert 95.0 <= float(m.group(1)) <= 105.0
