"""The port's training path against the reference's, arch by arch, on the
CPU.

For each of the ten ``reduced_config`` archs in f32 both packages get the
same parameters (``repro_torch.models.convert.numpy_params``, mapped onto
the port with ``from_reference``) and the same numpy batch (B=2, S=32,
``repro_torch.train.fixtures.numpy_train_batch``).  The reference side runs
once per arch (``jax.jit`` of ``jax.grad(loss_fn)`` and of
``make_train_step``) in a module-scoped cache; then, as max |port -
reference|:

* the first step's loss within ``LOSS_RTOL`` = 1e-5 (relative), each
  gradient leaf within ``GRAD_RTOL`` = 1e-4 of that leaf's largest
  |gradient| (f32 sums in other orders; misses measured up to 1.5e-5, the
  hymba SSD leaves), and the metrics of each of 3 steps within
  ``LOSS_RTOL``, or, after the first step, ten times the reference's own
  spread if that is larger (``self_spread`` of ``reference_train.json``:
  how far the reference's metric moves when its parameters start one f32
  ulp away; hymba's grad_norm moves 3.7e-4 by step 3);
* the parameters after 3 steps within ``ADAM_STEP_BOUND`` (2.05) times the
  summed learning rate: an AdamW step moves an element by about lr where
  |g| >> eps whatever g's rounding, so two runs whose gradients differ only
  in rounding can end that far apart; misses measured below 0.02 of it;
* the port against the committed ``reference_train.json`` (the reduced
  cases; the full-width gemma3-1b case is held at ``--regenerate`` and on
  the card: on a CPU it takes minutes and about 12 GB).

Regenerate that fixture (needs jax; about 5 minutes and 20 GB for the
full-width case)::

    PYTHONPATH=src python tests/test_torch_train.py --regenerate
"""
import contextlib
import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.configs import base as R_base
from repro.models import transformer as RT
from repro.optim import adamw as R_adamw
from repro.optim import compression as R_comp
from repro.train import steps as R_steps

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as train_cli
from repro_torch.models import convert
from repro_torch.optim.tree import leaves
from repro_torch.train import fixtures
from repro_torch.train import steps as P_steps

ARCH_LIST = sorted(registry.ARCHS)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def ref_cfg(cfg):
    """The reference's ``ModelConfig`` with the port config's fields."""
    d = dataclasses.asdict(cfg)
    return R_base.ModelConfig(**{**d, "moe": R_base.MoEConfig(**d["moe"]),
                                 "ssm": R_base.SSMConfig(**d["ssm"])})


def jax_params(cfg, tree):
    """A numpy tree as the reference's parameters (each leaf its dtype)."""
    shapes_ = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                    ref_cfg(cfg)))
    return jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype),
                                  tree, shapes_)


def ref_train(case, tree, grads=False):
    """The reference's ``make_train_step`` over ``case.steps`` steps from
    ``tree``: ([metrics per step], final parameters as numpy, the first
    step's (grads, loss) if ``grads``)."""
    rcfg = ref_cfg(case.cfg)
    rtc = R_base.TrainConfig(**dataclasses.asdict(case.tc))
    params = jax_params(case.cfg, tree)
    batch = {k: jnp.asarray(v) for k, v in fixtures.numpy_train_batch(
        case.cfg, case.batch, case.seq_len).items()}
    state = {"params": params, "opt": R_adamw.init_moments(params),
             "step": jnp.zeros((), jnp.int32)}
    if case.tc.grad_compression == "int8_ef":
        state["error_fb"] = R_comp.init_error_feedback(params)
    first = None
    if grads:
        g, (loss, _) = jax.jit(jax.grad(lambda p, b: R_steps.loss_fn(
            p, rcfg, b, remat=case.tc.remat), has_aux=True))(params, batch)
        first = (jax.tree_util.tree_map(np.asarray, g), float(loss))
    step = jax.jit(R_steps.make_train_step(rcfg, rtc))
    metrics = []
    for _ in range(case.steps):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in fixtures.METRICS})
    final = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   state["params"])
    return metrics, final, first


def _case(arch):
    return next(c for c in fixtures.train_cases() if c.name == arch)


@pytest.fixture(scope="module")
def runs():
    """Per arch: the case, its numpy tree and the reference's run."""
    cache = {}

    def get(arch):
        if arch not in cache:
            case = _case(arch)
            tree = convert.numpy_params(case.cfg, fixtures.SEED_PARAMS)
            cache[arch] = (case, tree, ref_train(case, tree, grads=True))
        return cache[arch]
    return get


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_train_step_matches_reference(arch, runs, record_property):
    case, tree, (metrics, final, (grads, loss)) = runs(arch)
    params = convert.from_reference(case.cfg, tree)
    batch = {k: torch.from_numpy(v) for k, v in fixtures.numpy_train_batch(
        case.cfg, case.batch, case.seq_len).items()}
    g, l, _ = P_steps.grads_and_loss(params, case.cfg, batch,
                                     remat=case.tc.remat)
    assert _rel(float(l), loss) <= LOSS_RTOL, (float(l), loss)
    worst = 0.0
    flat = jax.tree_util.tree_leaves_with_path(grads)
    assert len(flat) == len(leaves(g))
    for (path, want), got in zip(flat, leaves(g)):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        bound = GRAD_RTOL * max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= bound, (f"d{jax.tree_util.keystr(path)}: {err:.3g} > "
                              f"{bound:.3g}")
        worst = max(worst, err / bound)
    record_property("grad_share_of_tol", worst)

    got_metrics, got_params = fixtures.train_run(params, case)
    entry = fixtures.load()["cases"][arch]
    for i, (a, b) in enumerate(zip(got_metrics, metrics)):
        for k in fixtures.METRICS:
            # the first step's metrics from the same parameters; a later
            # step's also within ten times the reference's own spread
            tol = (LOSS_RTOL if i == 0 else
                   max(LOSS_RTOL, fixtures.SPREAD_FACTOR
                       * entry["self_spread"][i][k]))
            assert abs(a[k] - b[k]) <= tol * max(abs(b[k]), 1e-30), \
                (i, k, a[k], b[k], tol)
    tol = fixtures.ADAM_STEP_BOUND * sum(m["lr"] for m in metrics)
    perr = max(float(np.abs(b.numpy() - a).max()) for a, b in zip(
        jax.tree_util.tree_leaves(final), leaves(got_params)))
    record_property("param_share_of_tol", perr / tol)
    assert perr <= tol, f"parameters after {case.steps} steps: {perr:.3g} > " \
        f"{tol:.3g}"


def test_vlm_loss_aligns_short_labels():
    """Labels shorter than the sequence (a VLM's patch prefix) are held
    against the last logits, as the reference's ``loss_fn`` does."""
    case = _case("pixtral-12b")
    tree = convert.numpy_params(case.cfg, 0)
    b = fixtures.numpy_train_batch(case.cfg, 2, 32)
    b["labels"] = b["labels"][:, -b["tokens"].shape[1]:]
    assert b["labels"].shape[1] < 32
    rcfg = ref_cfg(case.cfg)
    want, (wl, _) = jax.jit(lambda p, bb: R_steps.loss_fn(p, rcfg, bb))(
        jax_params(case.cfg, tree), {k: jnp.asarray(v) for k, v in b.items()})
    got, (gl, _) = P_steps.loss_fn(convert.from_reference(case.cfg, tree),
                                   case.cfg, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
    assert _rel(float(got), float(want)) <= LOSS_RTOL
    assert _rel(float(gl), float(wl)) <= LOSS_RTOL


def test_train_state_layout():
    """``init_train_state``: the reference's keys, f32 moments of each
    parameter's shape, an int32 step 0; a step keeps every dtype and
    writes no tensor of the state it was given."""
    cfg = registry.reduced_config("qwen1.5-0.5b")
    gen = torch.Generator().manual_seed(0)
    state = P_steps.init_train_state(gen, cfg)
    assert sorted(state) == ["opt", "params", "step"]
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for p, m, v in zip(leaves(state["params"]), leaves(state["opt"]["m"]),
                       leaves(state["opt"]["v"])):
        assert m.dtype == v.dtype == torch.float32 and m.shape == p.shape
    before = [t.clone() for t in leaves(state)]
    batch = {k: torch.from_numpy(v) for k, v in fixtures.numpy_train_batch(
        cfg, 2, 16).items()}
    new, m = P_steps.make_train_step(cfg, TrainConfig(warmup_steps=1))(
        state, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(state)))
    assert sorted(m) == ["aux_loss", "grad_norm", "loss", "lr"]
    assert int(new["step"]) == 1 and new["step"].dtype == torch.int32
    assert [t.dtype for t in leaves(new)] == [t.dtype for t in before]


def test_train_loss_decreases_on_learnable_data():
    """Twin of the reference's end-to-end sanity check: a tiny model must
    fit a repetitive stream (last loss below 0.7 of the first)."""
    cfg = registry.reduced_config("qwen1.5-0.5b")
    state = P_steps.init_train_state(torch.Generator().manual_seed(0), cfg)
    tc = TrainConfig(learning_rate=3e-3, total_steps=40, warmup_steps=4)
    step = P_steps.make_train_step(cfg, tc)
    toks = (torch.arange(32, dtype=torch.int32)[None].repeat(4, 1)
            % cfg.vocab_size)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    losses = []
    for _ in range(40):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


# ---------------------------------------------------------------- fixture
@pytest.mark.parametrize("name", [c.name for c in fixtures.train_cases()
                                  if c.batch * c.seq_len <= 64])
def test_port_matches_committed_train_fixture(name):
    """The same comparison ``chip_smoke.py`` phase 12 makes on the card."""
    case = next(c for c in fixtures.train_cases() if c.name == name)
    params = convert.from_reference(
        case.cfg, convert.numpy_params(case.cfg, fixtures.SEED_PARAMS))
    res = fixtures.compare(fixtures.load()["cases"][name],
                           *fixtures.train_run(params, case))
    assert res["ok"], res


def test_train_fixture_states_its_cases():
    doc = fixtures.load()
    cases = fixtures.train_cases()
    assert sorted(doc["cases"]) == sorted(c.name for c in cases)
    for c in cases:
        e = doc["cases"][c.name]
        assert (e["arch"], e["n_layers"], e["batch"], e["seq_len"],
                e["steps"], e["param_stride"]) == (
            c.cfg.arch_id, c.cfg.n_layers, c.batch, c.seq_len, c.steps,
            c.param_stride)
        assert e["train_config"] == dataclasses.asdict(c.tc)
        assert len(e["metrics"]) == c.steps
    g = next(c for c in cases if c.name == "gemma3-1b@6L")
    assert (g.cfg.d_model, g.cfg.d_ff, g.cfg.vocab_size, g.cfg.head_dim,
            g.cfg.n_layers) == (1152, 6912, 262_144, 256, 6)
    assert g.seq_len > g.cfg.sliding_window
    assert {c.tc.remat for c in cases} == {"none", "block"}
    assert any(c.tc.microbatches == 2 and c.tc.grad_compression == "int8_ef"
               for c in cases)
    # the regeneration ran the port on the CPU too and recorded its miss
    assert sorted(doc["cpu_port_check"]) == sorted(doc["cases"])
    assert all(r["ok"] for r in doc["cpu_port_check"].values())


# ----------------------------------------------------------------- the CLI
def test_train_cli_runs_on_the_cpu_when_asked(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(["--device", "cpu", "--arch", "hymba-1.5b",
                             "--steps", "3", "--batch", "2", "--seq-len",
                             "16", "--ckpt-dir", str(tmp_path),
                             "--log-every", "1", "--remat", "block"])
    out = buf.getvalue().splitlines()
    lines = [ln for ln in out if ln.startswith("[train]")]
    assert rc == 0
    assert lines[0] == ("[train] arch=hymba-1.5b preset=smoke params=0.1M "
                        "mesh={'data': 1, 'model': 1}")
    assert [ln.split()[2] for ln in lines[1:4]] == ["0", "1", "2"]
    assert lines[-1].startswith("[train] done in ") and \
        "resumed_from=None recoveries=0" in lines[-1]
    doc = json.loads(next(ln for ln in out if ln.startswith("{")))
    assert doc["device"] == "cpu" and len(doc["step_ms"]) == 3
    assert doc["ckpt_step"] == 2 and doc["ckpt_bytes"] > 0
    assert np.isfinite(doc["final_metrics"]["loss"])
    assert doc["flops_per_step"] == train_cli.train_flops(
        registry.reduced_config("hymba-1.5b"), 2, 16)


def test_train_flops_count():
    """6 x parameters x tokens plus 12 x head_dim x heads per live score:
    gemma3-1b at B=4, S=1024 (22 local layers of window 512, 4 global)."""
    cfg = registry.get_config("gemma3-1b")
    local = sum(min(q + 1, 512) for q in range(1024))
    glob = 1024 * 1025 // 2
    want = (6 * 999_811_584 * 4096
            + 12 * 256 * 4 * 4 * (22 * local + 4 * glob))
    assert cfg.param_count() == 999_811_584
    assert train_cli.train_flops(cfg, 4, 1024) == want


def test_train_cli_refuses_model_parallel(tmp_path, capsys):
    """``--model-parallel 2`` is no longer refused: one process runs it on
    the reference's host mesh, (1, 1) over one rank, as the reference does
    on one jax device, with the losses of ``--model-parallel 1``."""
    losses = []
    for mp in ("1", "2"):
        assert train_cli.main(["--device", "cpu", "--steps", "3", "--batch",
                               "2", "--seq-len", "16", "--model-parallel",
                               mp, "--ckpt-dir", str(tmp_path / mp)]) == 0
        out = capsys.readouterr().out
        assert "mesh={'data': 1, 'model': 1}" in out
        doc = json.loads(next(line for line in out.splitlines()
                              if line.startswith("{")))
        assert doc["kernel_launches"] and not any(
            doc["kernel_launches"].values())
        losses.append(doc["losses"])
    assert losses[1] == losses[0] and len(losses[0]) == 3


# ------------------------------------------------------------ regenerate
def regenerate():
    doc = {"about": "reference training outputs (repro.train.steps, jax on "
                    "the CPU) for repro_torch.train.fixtures",
           "jax_version": jax.__version__,
           "seed_params": fixtures.SEED_PARAMS,
           "seed_inputs": fixtures.SEED_INPUTS,
           "seed_labels": fixtures.SEED_LABELS,
           "metric_rtol": fixtures.METRIC_RTOL,
           "spread_factor": fixtures.SPREAD_FACTOR,
           "seed_noise": fixtures.SEED_NOISE,
           "adam_step_bound": fixtures.ADAM_STEP_BOUND,
           "cases": {}, "cpu_port_check": {}}
    for case in fixtures.train_cases():
        tree = convert.numpy_params(case.cfg, fixtures.SEED_PARAMS)
        noisy, _, _ = ref_train(case, fixtures.ulp_noise(tree))
        metrics, final, _ = ref_train(case, tree)
        entry = fixtures.record(case, metrics, final,
                                fixtures.spread(metrics, noisy))
        del final
        got = fixtures.train_run(convert.from_reference(case.cfg, tree), case)
        check = fixtures.compare(entry, *got)
        del got, tree
        print(case.name, json.dumps(check), flush=True)
        if not check["ok"]:
            raise SystemExit(f"the port disagrees with the reference on "
                             f"{case.name}: {check}")
        doc["cases"][case.name] = entry
        doc["cpu_port_check"][case.name] = check
    fixtures.FIXTURE.write_text(json.dumps(doc, separators=(",", ":")) + "\n")
    print("wrote", fixtures.FIXTURE)


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        raise SystemExit("usage: python tests/test_torch_train.py "
                         "--regenerate")
    regenerate()
