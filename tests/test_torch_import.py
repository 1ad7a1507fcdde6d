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


_FORBIDDEN = re.compile(r"\bimport jax\b|\bfrom jax\b|\bimport repro\b"
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
    # the kernels' own wrappers: a CPU tensor takes the plain version
    out = replay_columns_batch(torch.zeros(3, dtype=torch.int64),
                               torch.zeros(3, dtype=torch.bool),
                               [fixtures.CACHES["32K+256K"]])
    assert out[0][0].device.type == "cpu"
