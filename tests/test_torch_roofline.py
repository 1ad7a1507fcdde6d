"""The port's HLO-text parsing, roofline table and elastic re-mesh against
the reference's (twins of ``tests/test_hlo_roofline.py::{test_shape_bytes,
test_collective_parse_synthetic}`` and more).

All of these are pure functions, so each is held ``==`` the reference's on
the same input: HLO strings, dry-run records (synthetic ones, and the
records of the card's phase-14 cells committed in
``src/repro_torch/launch/fixtures/reference_roofline.json`` beside the
reference's rows on them), and live-device counts.
``python tests/test_torch_roofline.py --regenerate [DIR]`` rewrites the
fixture from the dry-run records in DIR (default ``build/dryrun_torch``),
refusing when the port's rows disagree.
"""
import json
import sys
import textwrap

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.configs.registry import ARCHS
from repro.core import hlo as ref_hlo
from repro.core import hlo_cost as ref_cost
from repro.core import roofline as ref_roofline
from repro_torch.core import hlo, hlo_cost, roofline
from repro_torch.launch import fixtures as launch_fixtures

SHAPE_STRINGS = [
    "f32[128,256]", "bf16[10]", "(f32[8], s32[4])", "pred[]", "pred[2]",
    "f8e4m3fn[16,2]", "u8[3]", "s64[2,2]", "c64[4]", "(bf16[2,3]{1,0}, "
    "f16[5]{0}, u32[])", "token[]", "f64[0]", "no shape here",
]


@pytest.mark.parametrize("s", SHAPE_STRINGS)
def test_shape_bytes_equals_reference(s):
    assert hlo.shape_bytes(s) == ref_hlo.shape_bytes(s)


def test_shape_bytes_cases():
    assert hlo.shape_bytes("f32[128,256]") == 128 * 256 * 4
    assert hlo.shape_bytes("bf16[10]") == 20
    assert hlo.shape_bytes("(f32[8], s32[4])") == 32 + 16


COLLECTIVE_TEXTS = [
    """
      %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={}
      %ag = bf16[2,512]{1,0} all-gather(bf16[1,512]{1,0} %y), dimensions={0}
      %rs = f32[256]{0} reduce-scatter(f32[1024]{0} %z), dimensions={0}
      %cp = f32[16]{0} collective-permute(f32[16]{0} %w)
    """,
    """
      %a2a = (f32[4,8]{1,0}, f32[4,8]{1,0}) all-to-all(f32[4,8]{1,0} %p, f32[4,8]{1,0} %q)
      %ar.1 = bf16[7,3]{1,0} all-reduce(bf16[7,3]{1,0} %r), to_apply=%add
      %ar.2 = bf16[7,3]{1,0} all-reduce-start(bf16[7,3]{1,0} %r)
      %x = f32[3]{0} add(f32[3]{0} %a, f32[3]{0} %b)
      %w = (s32[], f32[4]) while(%t), trip_count=12
    """,
    "",
]


@pytest.mark.parametrize("text", COLLECTIVE_TEXTS)
def test_collective_bytes_and_trip_counts_equal_reference(text):
    text = textwrap.dedent(text)
    assert hlo.collective_bytes(text) == ref_hlo.collective_bytes(text)
    assert hlo.scan_trip_counts(text) == ref_hlo.scan_trip_counts(text)


def test_collective_parse_synthetic():
    got = hlo.collective_bytes(textwrap.dedent(COLLECTIVE_TEXTS[0]))
    assert got["all-reduce"] == 4096
    assert got["all-gather"] == 2 * 512 * 2
    assert got["reduce-scatter"] == 1024
    assert got["collective-permute"] == 64
    assert got["total"] == 4096 + 2048 + 1024 + 64
    assert got["all-reduce_count"] == 1


def test_patterns_are_the_reference_patterns():
    assert hlo._COLL_RE.pattern == ref_hlo._COLL_RE.pattern
    assert hlo._SHAPE_RE.pattern == ref_hlo._SHAPE_RE.pattern
    assert hlo._DTYPE_BYTES == ref_hlo._DTYPE_BYTES
    for name in ("_HDR_RE", "_PARAM_RE", "_INST_RE", "_DOT_ARGS_RE",
                 "_LHS_C_RE", "_LHS_B_RE", "_TRIP_RE", "_TRIP_RE2",
                 "_BODY_RE", "_CALLS_RE", "_COND_RE", "_BRANCHES_RE",
                 "_APPLY_RE", "_SHAPE_DIMS_RE", "_REF_RE"):
        assert getattr(hlo_cost, name).pattern == \
            getattr(ref_cost, name).pattern, name


HLO_MODULE = textwrap.dedent("""
    HloModule jit_step, entry_computation_layout={(f32[8,16]{1,0})->f32[8,4]{1,0}}

    %fused_computation (param_0: f32[8,16], param_1: f32[8,16]) -> f32[8,16] {
      %param_0 = f32[8,16]{1,0} parameter(0)
      %param_1 = f32[8,16]{1,0} parameter(1)
      ROOT %add.1 = f32[8,16]{1,0} add(f32[8,16]{1,0} %param_0, f32[8,16]{1,0} %param_1)
    }

    %sum (x: f32[], y: f32[]) -> f32[] {
      %x = f32[] parameter(0)
      %y = f32[] parameter(1)
      ROOT %s = f32[] add(f32[] %x, f32[] %y)
    }

    %body (p: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
      %p = (s32[], f32[8,16]{1,0}) parameter(0)
      %i = s32[] get-tuple-element((s32[], f32[8,16]{1,0}) %p), index=0
      %h = f32[8,16]{1,0} get-tuple-element((s32[], f32[8,16]{1,0}) %p), index=1
      %w = f32[16,16]{1,0} constant({...})
      %dot.1 = f32[8,16]{1,0} dot(f32[8,16]{1,0} %h, f32[16,16]{1,0} %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(step)/layer/dot"}
      %ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %dot.1), replica_groups={{0,1}}, to_apply=%sum
      %ag = f32[16,16]{1,0} all-gather(f32[8,16]{1,0} %ar), dimensions={0}
      ROOT %t = (s32[], f32[8,16]{1,0}) tuple(s32[] %i, f32[8,16]{1,0} %ar)
    }

    %cond (c: (s32[], f32[8,16])) -> pred[] {
      %c = (s32[], f32[8,16]{1,0}) parameter(0)
      ROOT %lt = pred[] constant(true)
    }

    %branch_a (ba: f32[8,16]) -> f32[8,16] {
      %ba = f32[8,16]{1,0} parameter(0)
      ROOT %neg = f32[8,16]{1,0} negate(f32[8,16]{1,0} %ba)
    }

    ENTRY %main.7 (a: f32[8,16], b: f32[16,4]) -> f32[8,4] {
      %a = f32[8,16]{1,0} parameter(0)
      %b = f32[16,4]{1,0} parameter(1)
      %init = (s32[], f32[8,16]{1,0}) tuple(s32[] %zero, f32[8,16]{1,0} %a)
      %while.1 = (s32[], f32[8,16]{1,0}) while((s32[], f32[8,16]{1,0}) %init), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"12"}}
      %h2 = f32[8,16]{1,0} get-tuple-element((s32[], f32[8,16]{1,0}) %while.1), index=1
      %fusion.3 = f32[8,16]{1,0} fusion(f32[8,16]{1,0} %h2, f32[8,16]{1,0} %a), kind=kLoop, calls=%fused_computation
      %cnd = f32[8,16]{1,0} conditional(pred[] %p0, f32[8,16]{1,0} %fusion.3), branch_computations={%branch_a, %branch_a}
      %rs = f32[4,4]{1,0} reduce-scatter(f32[8,4]{1,0} %x), dimensions={0}, to_apply=%sum
      ROOT %dot.2 = f32[8,4]{1,0} dot(f32[8,16]{1,0} %cnd, f32[16,4]{1,0} %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
    }
""")


@pytest.mark.parametrize("text", [HLO_MODULE, HLO_MODULE.replace(
    'backend_config={"known_trip_count":{"n":"12"}}', "trip_count=5"),
    HLO_MODULE.replace("ENTRY ", ""), "", "garbage\n}\n"])
@pytest.mark.parametrize("details", [False, True])
def test_analyze_hlo_equals_reference(text, details):
    got = hlo_cost.analyze_hlo(text, details=details)
    want = ref_cost.analyze_hlo(text, details=details)
    assert (got.flops, got.bytes, got.collectives, got.dot_profile) == \
        (want.flops, want.bytes, want.collectives, want.dot_profile)
    assert got.collective_total == want.collective_total
    assert got.top_dots(3) == want.top_dots(3)


def test_analyze_hlo_multiplies_loop_bodies_by_their_trips():
    cost = hlo_cost.analyze_hlo(HLO_MODULE)
    assert cost.flops == 12 * 2 * 8 * 16 * 16 + 2 * 8 * 4 * 16
    assert cost.collectives["all-reduce"] == 12 * 8 * 16 * 4
    assert cost.collectives["all-reduce_count"] == 12


# ------------------------------------------------------------ roofline
def _synthetic_records():
    from repro.configs.registry import get_config
    from repro.configs.shapes import ALL_SHAPES, cell_status
    rng = np.random.default_rng(0)
    recs = []
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            if cell_status(cfg, shape) != "run":
                continue
            for mesh, n in (("single", 256), ("multi", 512), ("host", 8)):
                flops = float(rng.uniform(1e9, 1e15))
                rec = {"arch": arch, "shape": shape.name, "mesh": mesh,
                       "ok": True, "n_devices": n,
                       "active_params": cfg.active_param_count(),
                       "flops_per_device": flops,
                       "bytes_accessed_per_device": float(rng.uniform(1e6, 1e13)),
                       "collectives": {"total": int(rng.integers(0, 1e12))}}
                if rng.random() < 0.5:
                    rec.update(flops_scaled_per_device=flops * 2,
                               bytes_scaled_per_device=float(rng.uniform(1e6, 1e12)),
                               collective_scaled_total=float(rng.uniform(0, 1e11)))
                recs.append(rec)
    recs.append({"arch": "gemma3-1b", "shape": "train_4k", "ok": False})
    return recs


@pytest.mark.parametrize("mp", [16, 1, 4])
def test_analytic_bytes_equal_reference(mp):
    from repro.configs.registry import get_config as ref_config
    from repro.configs.shapes import ALL_SHAPES as REF_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    for arch in sorted(ARCHS):
        for shape in REF_SHAPES:
            for n in (256, 512, 8):
                assert roofline.analytic_bytes_per_device(
                    get_config(arch), SHAPES[shape.name], n, mp=mp) == \
                    ref_roofline.analytic_bytes_per_device(
                        ref_config(arch), shape, n, mp=mp)


def test_cell_roofline_and_table_equal_reference_on_synthetic_records():
    recs = _synthetic_records()
    got = [roofline.cell_roofline(r) for r in recs]
    want = [ref_roofline.cell_roofline(r) for r in recs]
    assert got == want and got[-1] is None
    rows = [r for r in got if r is not None]
    assert roofline.markdown_table(rows) == ref_roofline.markdown_table(rows)


def test_cell_roofline_equals_reference_on_the_phase_records():
    doc = launch_fixtures.load_roofline()
    assert len(doc["records"]) == 6
    for rec, row in zip(doc["records"], doc["rows"]):
        assert rec["ok"]
        assert roofline.cell_roofline(rec) == row
        assert ref_roofline.cell_roofline(rec) == row
    assert roofline.markdown_table(doc["rows"]) == doc["markdown"]


def test_full_table_and_bench_roofline_read_the_port_artifacts(
        tmp_path, monkeypatch, capsys):
    """``full_table`` / ``load_cell`` / ``python -m repro_torch.bench
    roofline`` read the port's artifact directory and give the reference's
    rows on the same files."""
    from repro_torch.bench import common
    from repro_torch.bench import run as bench_run
    from repro_torch.launch import dryrun
    doc = launch_fixtures.load_roofline()
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for rec in doc["records"]:
        for d in (port_dir, ref_dir):
            (d / rec["mesh"]).mkdir(parents=True, exist_ok=True)
            (d / rec["mesh"] / f"{rec['arch']}__{rec['shape']}.json") \
                .write_text(json.dumps(rec))
    monkeypatch.setattr(dryrun, "ART", port_dir)
    monkeypatch.setattr(ref_roofline, "ART", ref_dir)
    for mesh in ("single", "multi"):
        assert roofline.full_table(mesh) == ref_roofline.full_table(mesh)
    assert len(roofline.full_table("single")) == 5
    rec = doc["records"][0]
    assert roofline.load_cell(rec["arch"], rec["shape"], rec["mesh"]) == rec
    assert roofline.load_cell("yi-34b", "decode_32k") is None
    out = tmp_path / "bench"
    try:
        assert bench_run.main(["--device", "cpu", "--out", str(out),
                               "roofline"]) == 0
    finally:
        common.configure()
    printed = capsys.readouterr().out
    assert "Roofline: three terms" in printed and "gemma3-1b" in printed
    rows = json.loads((out / "roofline.json").read_text())
    assert rows == ref_roofline.full_table("single")


def test_bench_roofline_without_artifacts(tmp_path, monkeypatch, capsys):
    from repro_torch.bench import roofline as bench_roofline
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "ART", tmp_path / "none")
    assert bench_roofline.main() == []
    assert "no dry-run artifacts yet" in capsys.readouterr().out


# ------------------------------------------------------- elastic re-mesh
@pytest.mark.parametrize("min_mp", range(1, 9))
def test_elastic_remesh_shape_equals_reference(min_mp, monkeypatch):
    import jax
    from repro.ft import manager as ref_manager
    from repro_torch.ft.manager import remesh_shape
    for n in range(1, 17):
        seen = {}
        monkeypatch.setattr(jax, "devices", lambda n=n: list(range(n)))
        monkeypatch.setattr(jax, "make_mesh", lambda shape, axes, **kw:
                            seen.setdefault("shape", (tuple(shape), axes)))
        ref_manager.elastic_remesh(min_mp)
        assert (remesh_shape(n, min_mp), ("data", "model")) == seen["shape"]


def regenerate(records_dir=None):
    from repro_torch.launch import dryrun
    import pathlib
    d = pathlib.Path(records_dir) if records_dir else dryrun.ART
    records = []
    for arch, shape, mesh in launch_fixtures.PHASE_CELLS:
        rec = json.loads((d / mesh / f"{arch}__{shape}.json").read_text())
        assert rec.get("ok"), (arch, shape, mesh, rec.get("error"))
        records.append({k: v for k, v in rec.items() if k != "tb"})
    rows = [ref_roofline.cell_roofline(r) for r in records]
    if [roofline.cell_roofline(r) for r in records] != rows:
        raise SystemExit("the port's cell_roofline disagrees with the "
                         "reference's")
    launch_fixtures.ROOFLINE.write_text(json.dumps(
        {"records": records, "rows": rows,
         "markdown": ref_roofline.markdown_table(rows)}, indent=1) + "\n")
    print(f"wrote {launch_fixtures.ROOFLINE}")


if __name__ == "__main__":
    if "--regenerate" in sys.argv:
        rest = [a for a in sys.argv[1:] if a != "--regenerate"]
        regenerate(rest[0] if rest else None)
