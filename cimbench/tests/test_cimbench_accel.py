"""The accel kind beyond what every cell's runs check
(``test_cimbench_runs.py``): its cell run traced on the CPU, correct and
with the span readers' metrics; the readers' arithmetic on hand-built
spans; the step's FLOPs count; the reference's selection and pricing
against the program's; the configuration file against the catalog's
published config; and a checkout whose program lacks the kind failing at
once, with no result."""
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

from cimbench import accel_layer
from cimbench.bench import RunView
from cimbench.ref_accel import flops, granite, pricing
from cimbench.tests.cimbench_tiny import make_root

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "accel-granite-h-small-8k"
CONFIG = json.loads((ROOT / "cimbench" / "configs"
                     / "granite-4.0-h-small-ep8.json").read_text())
MS = 1_000_000
SPAN_METRICS = ("record_ms.accel", "fusion_ms.accel", "cost_ms.accel",
                "mamba_ms.accel", "moe_ms.accel")


def _run(root, trace: int):
    code = ("import json, sys; sys.path[:0] = [{r!r}, {s!r}]\n"
            "from cimbench.bench import run_cell\n"
            "out = run_cell({c!r}, 2147483651, 1.0, bool({t}), root={root!r},"
            " device='cpu')\n"
            "print(json.dumps(out))").format(
                r=str(ROOT), s=str(ROOT / "src"), c=CELL, t=trace,
                root=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    return _run(make_root(tmp_path_factory.mktemp("accel")), 1)


def test_traced_run_is_correct_and_reads_the_spans(traced):
    assert traced["correct"] and traced["failed"] == 0
    got = traced["metrics"]
    assert set(SPAN_METRICS) <= set(got)
    assert all(got[m]["value"] > 0 for m in SPAN_METRICS)
    assert got["record_ms.accel"]["value"] > got["mamba_ms.accel"]["value"]
    # no device trace on the CPU: the device's metrics are left out
    assert "device_idle.accel" not in got and "step_mfu.accel" not in got
    assert all(v["value"] <= v["limit"] for v in traced["checks"].values())


def span(sid, parent, name, dur):
    return {"span_id": sid, "parent_id": parent, "name": name, "cat": "x",
            "dur_ns": dur, "ts_ns": 0, "attrs": {}}


def test_span_readers_per_analysis():
    spans = [span("r", None, "tpu.record", 100 * MS),
             span("m1", "r", "model.mamba", 30 * MS),
             span("x", "m1", "model.moe", 4 * MS),
             span("m2", None, "model.mamba", 10 * MS),
             span("f", None, "tpu.fusion", 8 * MS)]
    run = RunView(units=[{"points": [0] * 9}] * 2, window_s=1.0,
                  setup_s=1.0, spans=spans)
    assert accel_layer.span_ms_per_analysis(run, "tpu.record") == 50.0
    assert accel_layer.span_ms_per_analysis(run, "tpu.fusion") == 4.0
    assert accel_layer.self_ms_per_analysis(run, "model.mamba") == 18.0
    assert accel_layer.self_ms_per_analysis(run, "model.moe") == 2.0
    assert accel_layer.span_ms_per_analysis(run, "tpu.cost") is None
    assert accel_layer.self_ms_per_analysis(run, "model.attn") is None
    run.spans = None
    assert accel_layer.span_ms_per_analysis(run, "tpu.record") is None


def test_step_mfu_reads_the_count_over_busy_time():
    run = RunView(units=[{"points": [0]}], window_s=2.0, setup_s=1.0)
    run.device = SimpleNamespace(busy_s=0.5)
    run.step_flops = [989e12 * 0.1, 989e12 * 0.1]
    assert accel_layer.step_mfu(run) == pytest.approx(40.0)
    run.device = None
    assert accel_layer.step_mfu(run) is None


def test_flops_count_from_widths_and_routing():
    spec = granite.Spec.of(CONFIG)
    T = 8192
    base = flops.forward_flops(spec, 1, T, [0] * 10)
    more = flops.forward_flops(spec, 1, T, [1000] + [0] * 9)
    assert more - base == 2.0 * 1000 * 3 * 4096 * 768
    # the projections of 9 Mamba-2 layers are most of the forward
    proj = 9 * (2.0 * T * 4096 * (8192 + 8448 + 128) + 2.0 * T * 8192 * 4096)
    assert 0.7 < proj / base < 0.75
    assert flops.step_flops(spec, 1, T, [0] * 10) == 3 * base


def test_reference_pricing_equals_the_program():
    """Selection and pricing from analysis numbers, the reference's copy
    against the program's TpuBackend: the same floats."""
    from repro_torch.dse import SweepSpace, TpuBackend, TpuOption, parse_bytes
    from repro_torch.dse.backends import TpuCandidate, TpuWorkloadAnalysis
    cands = [(3, 40_000, 20_000, 70_000), (5, 10, 10, 300_000),
             (2, 90_000_000, 50_000_000, 100_000), (7, 100, 100, 16_384)]
    an = TpuWorkloadAnalysis("w", 1, 8, 7.3e13, 9_876_543_210, 0.0, 1.0e10,
                             123_014, tuple(TpuCandidate(*c) for c in cands))
    nums = {"flops": an.flops, "total_bytes": an.total_bytes,
            "collective_bytes": an.collective_bytes, "n_eqns": an.n_eqns}
    be = TpuBackend()
    for chip in pricing.CHIPS:
        for thr in ("16K", "64K", "256K"):
            (p,) = SweepSpace(workloads=("w",), tpus=(TpuOption(
                TpuOption.of(chip).chip, parse_bytes(thr)),)).points()
            rec = be.price(p, an, be._select(
                an, parse_bytes(thr), TpuOption.of(chip).chip.vmem_bytes),
                None).to_dict()
            want = pricing.price(nums, cands, chip, thr)
            assert {k: rec[k] for k in want} == want


def test_configuration_file_holds_the_catalog_config():
    """Every key of the catalog's published config, equal where the cut
    does not name it; the three cut keys beside their published values."""
    published = {
        "hidden_size": 4096, "intermediate_size": 768,
        "shared_intermediate_size": 1536, "num_attention_heads": 32,
        "num_key_value_heads": 8, "mamba_n_heads": 128, "mamba_d_head": 64,
        "mamba_d_state": 128, "mamba_n_groups": 1, "mamba_d_conv": 4,
        "mamba_chunk_size": 256, "mamba_expand": 2,
        "num_experts_per_tok": 10, "attention_multiplier": 0.0078125,
        "embedding_multiplier": 12, "residual_multiplier": 0.22,
        "logits_scaling": 16, "rms_norm_eps": 1e-05,
        "position_embedding_type": "nope", "tie_word_embeddings": True,
        "model_type": "granitemoehybrid", "max_position_embeddings": 131072}
    assert {k: CONFIG[k] for k in published} == published
    assert CONFIG["reduced"] == ["num_hidden_layers", "num_local_experts",
                                 "vocab_size"]
    assert CONFIG["published"] == {"num_hidden_layers": 40,
                                   "num_local_experts": 72,
                                   "vocab_size": 100352}
    assert (CONFIG["num_hidden_layers"], CONFIG["num_local_experts"],
            CONFIG["vocab_size"]) == (10, 9, 12544)
    assert CONFIG["experts_held"] == list(range(9))
    assert len(CONFIG["layer_types"]) == 40


def test_a_program_without_the_kind_fails_at_once(tmp_path):
    """The cell on a program that lacks what the kind drives (here, no
    ``HybridMoEConfig``) exits non-zero before any unit, printing no
    result line."""
    root = make_root(tmp_path)
    code = ("import sys\n"
            "import repro_torch.configs.base as b\n"
            "del b.HybridMoEConfig\n"
            "sys.path[:0] = [{r!r}]\n"
            "from cimbench.bench import run_cell\n"
            "run_cell({c!r}, 1, 1.0, False, root={root!r}, device='cpu')\n"
            "print('RESULT')").format(r=str(ROOT), c=CELL, root=str(root))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "RESULT" not in proc.stdout
    assert "HybridMoEConfig" in proc.stderr
