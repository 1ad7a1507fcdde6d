"""The port's sharded dry run (twin of
``tests/test_hlo_roofline.py::test_sharded_lowering_8dev``).

Each case runs in a subprocess of its own, since the fake process group is
process-global: a reduced config's train step is recorded per device on a
fake (2, 4) (data, model) mesh, on meta DTensors, with jax and the
reference blocked, and must record ``ok: true`` with collective bytes > 0.  The FLOP checks hold the recorder
to counting one device's work: at world size 1 it counts what
``FlopCounterMode`` counts; under ``strategy="data"`` each device does
exactly the world-1 count / 2; under ``"auto"`` between / 8 and / 2.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

ROOT = pathlib.Path(__file__).resolve().parents[1]

_REDUCED = textwrap.dedent("""
    import json, sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.cells import build_cell_for
    from repro_torch.launch.dryrun import flop_checks, init_fake_group, record_json
    from repro_torch.launch.mesh import make_mesh

    arch, kind = sys.argv[1], sys.argv[2]
    init_fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = reduced_config(arch)
    shape = ShapeConfig("t", seq_len=32, global_batch=8, kind=kind)

    def build(strategy):
        rules = shd.make_rules(cfg, mesh, shape, strategy=strategy)
        return build_cell_for(cfg, shape, mesh, rules, strategy=strategy)
    rec = record_json({"arch": arch}, build("auto").record(), mesh.size())
    checks = flop_checks(build, rec["flops_per_device"])
    from repro_torch.core import roofline
    from repro_torch.dist import fixtures
    assert not fixtures.mismatches(fixtures.port_records(), fixtures.load())
    loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps({"rec": rec, "checks": checks, "loaded": loaded}))
""")


def _run(code, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,kind", [
    ("qwen1.5-0.5b", "train"), ("moonshot-v1-16b-a3b", "train"),
    ("xlstm-125m", "train"), ("gemma3-1b", "prefill"),
    ("hymba-1.5b", "decode")])
def test_reduced_cell_records_per_device_on_a_fake_2x4_mesh(arch, kind):
    out = _run(_REDUCED, arch, kind)
    rec, checks = out["rec"], out["checks"]
    assert out["loaded"] == []                   # jax and repro blocked
    assert rec["ok"] and rec["n_devices"] == 8 and rec["eqns"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["collective_scaled_total"] == rec["collectives"]["total"]
    assert rec["flops_scaled_per_device"] == rec["flops_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert checks["world1_equals_counter"], checks
    assert checks["data_is_world1_over_data"], checks
    assert checks["auto_within_bounds"], checks


_DRYRUN_MAIN = textwrap.dedent("""
    import json, sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None
    from repro_torch.launch import dryrun
    out = sys.argv[1]
    args = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--device", "cpu",
            "--out", out]
    rc1 = dryrun.main(args)
    rc2 = dryrun.main(args + ["--shape", "long_500k"])
    rc3 = dryrun.main(["--arch", "yi-34b", "--shape", "long_500k", "--device",
                       "cpu", "--out", out])
    print(json.dumps([rc1, rc2, rc3]))
""")


def test_dryrun_main_writes_resumable_artifacts(tmp_path):
    """``python -m repro_torch.launch.dryrun`` at published widths on the
    (16, 16) mesh of a world-256 fake group: a decode cell, a skipped cell,
    and a rerun that reads the artifact back instead of recording."""
    out = tmp_path / "dry"
    assert _run(_DRYRUN_MAIN, str(out)) == [0, 0, 0]
    rec = json.loads((out / "single" / "gemma3-1b__decode_32k.json")
                     .read_text())
    assert rec["ok"] and rec["n_devices"] == 256 and rec["mesh"] == "single"
    assert rec["collectives"]["total"] > 0 and rec["while_trip_counts"] == []
    assert rec["memory"]["temp_bytes"] is None
    assert rec["kernel_launches"] and not any(
        rec["kernel_launches"].values())
    skip = json.loads((out / "single" / "yi-34b__long_500k.json").read_text())
    assert skip["status"].startswith("skip") and "ok" not in skip
    stamp = (out / "single" / "gemma3-1b__decode_32k.json").stat().st_mtime_ns
    from repro_torch.launch import dryrun
    again = dryrun.run_cell("gemma3-1b", "decode_32k", "single",
                            device="cpu", out_dir=out)
    assert again == rec
    assert (out / "single" / "gemma3-1b__decode_32k.json").stat() \
        .st_mtime_ns == stamp


def test_a_failing_cell_is_recorded_and_the_sweep_fails(tmp_path):
    code = textwrap.dedent("""
        import json, sys
        from repro_torch.launch import cells, dryrun
        def broken(*a, **k):
            raise RuntimeError("no strategy for this op")
        cells.build_cell = broken
        rc = dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                          "--device", "cpu", "--out", sys.argv[1]])
        print(json.dumps(rc))
    """)
    assert _run(code, str(tmp_path)) == 1
    rec = json.loads((tmp_path / "single" / "gemma3-1b__decode_32k.json")
                     .read_text())
    assert rec["ok"] is False and "no strategy" in rec["error"]
