"""The sharded drivers on the CPU: ``launch.mesh``, ``elastic_remesh`` and
``--model-parallel`` under ``torchrun`` with gloo.

Every case runs in processes of its own (a process group is process-wide).
Four ranks with ``--model-parallel 2`` make a (2, 2) mesh: parameters and
moments split by the specs, batches by rows, collectives over gloo.  The
drivers must compute what one process computes: f32 losses within 1e-4
and the same greedy tokens, and a run that recovers from a failure resumes
from a checkpoint rank 0 wrote from the full tensors.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _launch(module, args, ranks=1, timeout=300):
    cmd = [sys.executable]
    if ranks > 1:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                f"--nproc-per-node={ranks}"]
    cmd += ["-m", module, "--device", "cpu", *args]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    return proc.stdout


def _json_line(out):
    return json.loads(next(line for line in out.splitlines()
                           if line.startswith("{")))


def test_train_model_parallel_2_on_4_ranks_equals_one_rank(tmp_path):
    args = ["--steps", "4", "--batch", "4", "--seq-len", "32",
            "--dtype", "float32", "--log-every", "1", "--save-every", "2",
            "--fail-at", "3"]
    one = _launch("repro_torch.launch.train",
                  args + ["--ckpt-dir", str(tmp_path / "one")])
    four = _launch("repro_torch.launch.train",
                   args + ["--ckpt-dir", str(tmp_path / "four"),
                           "--model-parallel", "2"], ranks=4)
    a, b = _json_line(one), _json_line(four)
    assert a["mesh"] == {"data": 1, "model": 1}
    assert b["mesh"] == {"data": 2, "model": 2}
    assert "mesh={'data': 2, 'model': 2}" in four
    assert four.count("[train] done") == 1            # rank 0 prints
    # steps 0-2, the injected failure at 3, a resume from the step-2
    # snapshot, step 3: four losses, the same in both runs
    assert len(a["losses"]) == len(b["losses"]) == 4
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=0, atol=1e-4)
    assert "recoveries=1" in one and "recoveries=1" in four
    with np.load(tmp_path / "one" / "3.npz") as za, \
            np.load(tmp_path / "four" / "3.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].shape == zb[k].shape, k
            np.testing.assert_allclose(zb[k], za[k], rtol=0, atol=1e-4,
                                       err_msg=k)


def test_serve_model_parallel_2_on_4_ranks_equals_one_rank():
    args = ["--dtype", "float32", "--gen", "6", "--prompt-len", "16"]
    one = _json_line(_launch("repro_torch.launch.serve", args))
    four_out = _launch("repro_torch.launch.serve",
                       args + ["--model-parallel", "2"], ranks=4)
    four = _json_line(four_out)
    assert four["mesh"] == {"data": 2, "model": 2}
    assert four["tokens"] == one["tokens"]
    assert four_out.count("[serve] sample tokens") == 1


def test_model_parallel_on_one_process_runs_as_1x1(tmp_path):
    out = _launch("repro_torch.launch.train",
                  ["--steps", "2", "--batch", "2", "--seq-len", "16",
                   "--model-parallel", "2", "--ckpt-dir", str(tmp_path)])
    assert "mesh={'data': 1, 'model': 1}" in out
    served = _json_line(_launch("repro_torch.launch.serve",
                                ["--gen", "3", "--prompt-len", "8",
                                 "--model-parallel", "2"]))
    assert served["mesh"] == {"data": 1, "model": 1}


_WORLD1 = """
import json, torch.distributed as dist
from repro_torch.dist import sharding as shd
from repro_torch.ft.manager import elastic_remesh
from repro_torch.launch.mesh import make_host_mesh
assert not dist.is_initialized()
out = {"host": shd.mesh_axes(make_host_mesh(2, device="cpu")),
       "elastic": shd.mesh_axes(elastic_remesh(4, device="cpu")),
       "backend": dist.get_backend(), "world": dist.get_world_size()}
print(json.dumps(out))
"""


def test_host_mesh_and_elastic_remesh_on_one_process():
    proc = subprocess.run([sys.executable, "-c", _WORLD1], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "host": {"data": 1, "model": 1}, "elastic": {"data": 1, "model": 1},
        "backend": "gloo", "world": 1}


_NO_ARGUMENT = """
import json, torch.distributed as dist
from repro_torch.ft.manager import elastic_remesh
from repro_torch.launch.mesh import make_host_mesh
out = {}
for name, fn in (("host", make_host_mesh), ("elastic", elastic_remesh)):
    try:
        out[name] = fn().device_type
    except Exception as e:  # noqa: BLE001 -- the outcome is the result
        out[name] = type(e).__name__
out["group"] = dist.is_initialized() and dist.get_backend()
print(json.dumps(out))
"""


def test_host_mesh_and_elastic_remesh_default_to_the_card():
    """Called with no device, both build their mesh (and the world-1 group
    under it) for the card: a CUDA mesh over nccl where there is one, an
    error and no group on a host without one -- never a CPU mesh."""
    import torch
    proc = subprocess.run([sys.executable, "-c", _NO_ARGUMENT], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if torch.cuda.is_available():
        assert out == {"host": "cuda", "elastic": "cuda", "group": "nccl"}
    else:
        assert out["host"] != "cpu" and out["elastic"] != "cpu"
        assert out["group"] is False


_RANKS = """
import json, os, torch.distributed as dist
from repro_torch.dist import sharding as shd
from repro_torch.ft.manager import elastic_remesh
from repro_torch.launch.mesh import make_host_mesh
out = {"host": shd.mesh_axes(make_host_mesh(2, device="cpu")),
       "host3": shd.mesh_axes(make_host_mesh(3, device="cpu")),
       "elastic": shd.mesh_axes(elastic_remesh(3, device="cpu"))}
if dist.get_rank() == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def test_host_mesh_and_elastic_remesh_over_four_ranks(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                           "--standalone", "--nproc-per-node=4", str(script)],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "host": {"data": 2, "model": 2}, "host3": {"data": 4, "model": 1},
        "elastic": {"data": 2, "model": 2}}
