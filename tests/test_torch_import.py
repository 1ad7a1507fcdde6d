"""The port stands alone: it imports without JAX, ``repro`` or triton, and
it runs where the caller asks -- ``device="cuda"`` without a card raises."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_RUN = r"""
import json, sys
for name in ("jax", "jaxlib", "repro", "triton"):
    sys.modules[name] = None           # any import of them now fails
from repro_torch.core import OffloadConfig, attach_cache_results, profile_system
from repro_torch.workloads import fixtures
st = fixtures.load_structural("NB", device="cpu")
tr = attach_cache_results(st, fixtures.CACHES["32K+256K"], device="cpu")
rep = profile_system(tr, OffloadConfig(), "sram", device="cpu")
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(json.dumps({"record": fixtures.report_record(rep), "loaded": loaded}))
"""


def test_port_runs_with_jax_repro_and_triton_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    golden = json.loads((ROOT / "src/repro_torch/workloads/fixtures/"
                         "reference_reports.json").read_text())
    want = next(r for r in golden["workloads"]["NB"]["records"]
                if (r["cache"], r["cim_levels"], r["tech"])
                == ("32K+256K", "both", "sram"))
    assert out["record"] == {k: want[k] for k in out["record"]}


_BLOCKED_KERNELS = r"""
import json, sys
for name in ("jax", "jaxlib", "repro", "triton"):
    sys.modules[name] = None           # any import of them now fails
import torch
from repro_torch import kernels
from repro_torch.kernels import ops, ref
g = torch.Generator().manual_seed(0)
x, y = (torch.randint(0, 2 ** 20, (17, 1000), generator=g, dtype=torch.int32)
        for _ in range(2))
q, k, v = (torch.randn(1, 2, 64, 16, generator=g) for _ in range(3))
gates = [torch.randn(1, 2, 64, generator=g) for _ in range(2)]
checks = {
    "bulk": torch.equal(ops.cim_bulk(x, y, op="add"), x + y),
    "fused": torch.equal(ops.cim_fused(x, y, x), (x + y) ^ x),
    "flash": torch.allclose(ops.flash_attention(q, k, v, block_q=32,
                                                block_k=32),
                            ref.flash_attention_ref(q, k, v), atol=2e-5),
    "mlstm": torch.allclose(ops.mlstm_chunkwise(q, k, v, *gates, chunk=16),
                            ref.mlstm_chunkwise_ref(q, k, v, *gates),
                            atol=2e-3),
}
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(json.dumps({"checks": checks, "loaded": loaded,
                  "kernels": list(kernels.KERNELS)}))
"""


def test_kernel_package_runs_with_jax_repro_and_triton_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_KERNELS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["checks"] == dict.fromkeys(("bulk", "fused", "flash",
                                           "mlstm"), True)
    assert out["kernels"] == ["cim_bitwise", "cim_bitwise_fused",
                              "flash_attention", "mlstm_chunkwise"]


_BLOCKED_DSE = r"""
import json, pathlib, sys, tempfile
for name in ("jax", "jaxlib", "repro", "triton"):
    sys.modules[name] = None           # any import of them now fails
from repro_torch.bench import run
from repro_torch.dse import DSEEngine, SweepSpace
from repro_torch.workloads import fixtures
res = DSEEngine(device="cpu").run(
    SweepSpace(workloads=("NB",), caches=("32K+256K", "64K+256K", "64K+2M")))
out = pathlib.Path(tempfile.mkdtemp())
rc = run.main(["--device", "cpu", "--out", str(out), "table3", "fig14"])
same = {f: (out / f).read_bytes() == (fixtures.ARTIFACTS_DIR / f).read_bytes()
        for stem in ("table3_energy", "fig14_cache_cfg")
        for f in (stem + ".csv", stem + ".json")}
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(json.dumps({"records": [r.to_dict() for r in res], "rc": rc,
                  "same": same, "loaded": loaded}))
"""


def test_dse_and_runner_run_with_jax_repro_and_triton_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_DSE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["rc"] == 0
    assert out["same"] == dict.fromkeys(
        ("table3_energy.csv", "table3_energy.json", "fig14_cache_cfg.csv",
         "fig14_cache_cfg.json"), True)
    # fig14's space is workload-major: its first three records are NB's
    golden = json.loads((ROOT / "src/repro_torch/workloads/fixtures/"
                         "reference_artifacts/records.json").read_text())
    assert out["records"] == golden["fig14"][:3]


_BLOCKED_TRACE = r"""
import json, sys
for name in ("jax", "jaxlib", "repro", "triton"):
    sys.modules[name] = None           # any import of them now fails
import numpy as np
from repro_torch.core.trace import trace_structural
from repro_torch.workloads import build, fixtures
same = {}
for name in ("DFS", "M2D"):
    st = trace_structural(*build(name)[:1], *build(name)[1], device="cpu")
    have, want = st.columns.to_arrays(), fixtures.load_arrays(name)
    same[name] = all(np.array_equal(have[k], want[k]) for k in have)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(json.dumps({"same": same, "loaded": loaded}))
"""


def test_trace_vm_runs_with_jax_repro_and_triton_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_TRACE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["same"] == {"DFS": True, "M2D": True}


_BLOCKED_SAMPLING = r"""
import json, pathlib, sys, tempfile
for name in ("jax", "jaxlib", "repro", "triton"):
    sys.modules[name] = None           # any import of them now fails
from repro_torch.bench import run
from repro_torch.core.sampling import SamplingSpec, sampled_structural
from repro_torch.dse import CimBackend, DSEEngine, SweepSpace
from repro_torch.workloads import fixtures
want = fixtures.reference_sampled()["suite"]["records"]["phase"]
res = DSEEngine(device="cpu", backend=CimBackend(
    sampling=SamplingSpec(mode="phase"))).run(
        SweepSpace(workloads=("NB",), techs=("sram", "fefet")))
spec = SamplingSpec(mode="stratified", interval=256, budget=4, warmup=256)
ss = sampled_structural("KM@4", spec)
out = pathlib.Path(tempfile.mkdtemp()) / "sampling.json"
rc = run.main(["sampling", "--device", "cpu", "--workloads", "NB",
               "--synthetic", "KM@2", "--json", str(out), "--no-check"])
doc = json.loads(out.read_text())
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(json.dumps({"same": [r.to_dict() for r in res]
                          == [r for r in want if r["workload"] == "NB"],
                  "windows": len(ss.plan.picks), "rc": rc,
                  "suite_err": doc["suite"]["worst_rel_err"],
                  "loaded": loaded}))
"""


def test_sampling_runs_with_jax_repro_and_triton_blocked():
    """The sampled pipeline, the sampled engine and ``python -m
    repro_torch.bench sampling`` import nothing of the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SAMPLING],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"same": True, "windows": 4, "rc": 0, "suite_err": 0.0,
                   "loaded": []}


def test_dse_and_runner_on_cuda_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    from repro_torch.bench import run
    from repro_torch.dse import AnalysisCache, DSEEngine

    for make in (DSEEngine, AnalysisCache,
                 lambda: DSEEngine(executor="process")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--out", str(tmp_path), "fig14"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["sampling", "--json", str(tmp_path / "s.json")])
    assert not list(tmp_path.iterdir())


_FORBIDDEN = re.compile(r"\bimport jax\b|\bfrom jax\b|\bimport repro\b"
                        r"|\bimport triton\b|\bfrom triton\b"
                        r"|\bfrom repro\.")


def test_no_jax_or_reference_import_in_port_sources():
    files = sorted((ROOT / "src/repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if _FORBIDDEN.search(line)]
    assert hits == []


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    from repro_torch.core import (OffloadConfig, attach_cache_results,
                                  profile_system, select_candidates)
    from repro_torch.core.accel.replay import replay_columns_batch
    from repro_torch.workloads import fixtures

    with pytest.raises(RuntimeError, match="no CUDA device"):
        fixtures.load_structural("NB")
    st = fixtures.load_structural("NB", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attach_cache_results(st)
    tr = attach_cache_results(st, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_candidates(tr.trace, OffloadConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_system(tr, OffloadConfig())
    # the CPU run of the same calls works
    assert profile_system(tr, OffloadConfig(), device="cpu").macr > 0
    from repro_torch.core.sampling import (SamplingSpec, attach_sampled,
                                           sampled_structural)
    ss = sampled_structural("hmmer", SamplingSpec(mode="stratified"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attach_sampled(ss, fixtures.CACHES["32K+256K"])
    assert attach_sampled(ss, fixtures.CACHES["32K+256K"],
                          device="cpu").windows[0].trace.n > 0
    # the kernels' own wrappers: a CPU tensor takes the plain version
    out = replay_columns_batch(torch.zeros(3, dtype=torch.int64),
                               torch.zeros(3, dtype=torch.bool),
                               [fixtures.CACHES["32K+256K"]])
    assert out[0][0].device.type == "cpu"
    from repro_torch.kernels import ops
    x = torch.zeros(8, 128, dtype=torch.int32)
    assert ops.cim_bulk(x, x).device.type == "cpu"


_BLOCKED_SERVICE = r"""
import io, json, sys
for name in ("jax", "jaxlib", "repro", "triton"):
    sys.modules[name] = None           # any import of them now fails
from repro_torch import obs
from repro_torch.dse.service import ServiceClient, running_server
from repro_torch.obs import export
with running_server(device="cpu") as (url, service):
    reply = ServiceClient(url).sweep(["NB"], techs=["sram", "fefet"])
    spans = service.buffered_spans()
buf = io.StringIO()
n = export.export_chrome(spans, (), buf)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(json.dumps({"records": reply.records, "n_spans": len(spans), "n": n,
                  "x": sum(e["ph"] == "X" for e in
                           json.loads(buf.getvalue())["traceEvents"]),
                  "loaded": loaded}))
"""


def test_service_and_exporters_run_with_jax_repro_and_triton_blocked():
    """The daemon serves one CPU request, and its spans export, with none
    of the reference's packages importable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SERVICE],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["n"] == out["x"] == out["n_spans"] > 0
    golden = json.loads((ROOT / "src/repro_torch/workloads/fixtures/"
                         "reference_artifacts/records.json").read_text())
    want = [dict(r, index=i) for i, r in enumerate(
        r for r in golden["fig16"] if r["workload"] == "NB")]
    assert len(want) == 2 and out["records"] == want


def test_service_entry_points_on_cuda_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.dse.service",
                           "--port", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "serving on" not in proc.stdout
    from repro_torch.bench import run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["service", "--json", str(tmp_path / "s.json")])
    assert not list(tmp_path.iterdir())
