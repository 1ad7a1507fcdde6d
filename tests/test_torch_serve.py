"""The port's serving path against the reference's, arch by arch, on the
CPU.

For each of the ten ``reduced_config`` archs in f32 both packages get the
same parameters (``repro_torch.models.convert.numpy_params``, mapped onto
the port with ``from_reference``) and the same numpy-drawn batch (B=2,
S=32).  The reference side runs once per arch (``jax.jit`` of its
``forward_full`` and ``forward_decode``) in a module-scoped cache; then:

* the prefill logits and the KV cache / recurrent state, within
  ``F32_TOL`` = 1e-4 (times max(1, the largest magnitude)); the misses
  measured are 4e-7 to 1.5e-5;
* one ``forward_decode`` from the reference's own prefill cache, and one
  from a fresh bf16 ``init_cache`` (the reference's default cache dtype):
  logits and the updated cache, same bound;
* the greedy tokens of ``make_prefill_step`` plus 4 ``make_decode_step``
  calls ``==`` the reference's;
* in the configs' own bf16, the prefill and first decode logits within
  ``BF16_ULPS`` = 6 bf16 ulps (2**-7 each) of the largest logit.  XLA may
  keep intermediates in f32 where torch rounds each op, so the two differ
  by a few ulps after a layer; misses measured 1 to 3.1 ulps.  The two MoE
  archs are left out of this case: a one-ulp difference before the router
  flips a top-k choice, which changes that token's output wholesale (their
  MoE layer is held in bf16 on identical input in
  ``tests/test_torch_models.py``);
* the port against the committed ``reference_serve.json``.

Regenerate that fixture (needs jax; about a minute and 8 GB for the
full-width gemma3-1b case)::

    PYTHONPATH=src python tests/test_torch_serve.py --regenerate
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
from repro.configs import registry as R_registry
from repro.configs import shapes as R_shapes
from repro.models import inputs as R_inputs
from repro.models import transformer as RT

from repro_torch.configs import registry, shapes
from repro_torch.launch import serve
from repro_torch.models import convert, fixtures
from repro_torch.models import inputs as P_inputs
from repro_torch.models import transformer as PT
from repro_torch.train import steps as P_steps

ARCH_LIST = sorted(registry.ARCHS)
MOE_ARCHS = [a for a in ARCH_LIST if registry.ARCHS[a].moe.n_experts]
B, S, STEPS = 2, 32, 4
F32_TOL = 1e-4
BF16_ULPS = 6


def ref_cfg(cfg):
    """The reference's ``ModelConfig`` with the port config's fields."""
    d = dataclasses.asdict(cfg)
    return R_base.ModelConfig(**{**d, "moe": R_base.MoEConfig(**d["moe"]),
                                 "ssm": R_base.SSMConfig(**d["ssm"])})


def f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def jax_params(cfg, tree):
    """A numpy tree as the reference's parameters (each leaf its dtype)."""
    shapes_ = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                    ref_cfg(cfg)))
    return jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype),
                                  tree, shapes_)


def ref_run(cfg, tree, batch, prompt_len, steps):
    """The reference's prefill and greedy decode steps: (tokens (B,
    1+steps), [logits per step, the prefill's for every position], [cache
    after each step])."""
    rcfg = ref_cfg(cfg)
    params = jax_params(cfg, tree)
    full = jax.jit(lambda p, b: RT.forward_full(
        p, rcfg, b, collect_cache=True, cache_len=prompt_len + steps))
    dec = jax.jit(lambda p, t, c, pos: RT.forward_decode(p, rcfg, t, c, pos))
    logits, _, cache = full(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    outs, caches = [np.asarray(logits, np.float32)], [cache]
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks = [tok]
    for i in range(steps):
        logits, cache = dec(params, tok, cache, jnp.int32(prompt_len + i))
        outs.append(np.asarray(logits, np.float32))
        caches.append(cache)
        tok = jnp.argmax(logits[:, -1], axis=-1, keepdims=True).astype(
            jnp.int32)
        toks.append(tok)
    return np.concatenate([np.asarray(t) for t in toks], axis=1), outs, caches


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _err(got, want, tol, what):
    """Asserts max |got - want| <= tol * max(1, max |want|); returns the
    share of that bound used (the margin is 1 minus it)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, \
        f"{what}: max |port - reference| {err:.3g} > {bound:.3g}"
    return err / bound


def _tree_err(got, want, tol, what):
    got, want = convert.to_numpy(got), np_tree(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want), what
    return max(_err(g, w, tol, f"{what} {jax.tree_util.keystr(path)}")
               for (path, g), w in zip(
                   jax.tree_util.tree_flatten_with_path(got)[0],
                   jax.tree_util.tree_leaves(want)))


@pytest.fixture(scope="module")
def runs():
    """Per arch: config, numpy tree and batch, the reference's run."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = f32(registry.reduced_config(arch))
            tree = convert.numpy_params(cfg, fixtures.SEED_PARAMS)
            batch = convert.numpy_batch(cfg, B, S, fixtures.SEED_INPUTS)
            cache[arch] = (cfg, tree, batch,
                           ref_run(cfg, tree, batch, S, STEPS))
        return cache[arch]
    return get


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ----------------------------------------------------------- configs, layout
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_configs_equal_reference(arch):
    """Every field of ARCHS[arch] and of reduced_config(arch), and the
    derived counts."""
    for got, want in ((registry.ARCHS[arch], R_registry.ARCHS[arch]),
                      (registry.reduced_config(arch),
                       R_registry.reduced_config(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.padded_vocab, got.param_count(),
                got.active_param_count(), got.q_dim, got.kv_dim,
                got.supports_long_decode) == (
            want.padded_vocab, want.param_count(), want.active_param_count(),
            want.q_dim, want.kv_dim, want.supports_long_decode)
    assert [shapes.cell_status(registry.ARCHS[arch], s)
            for s in shapes.ALL_SHAPES] == [
        R_shapes.cell_status(R_registry.ARCHS[arch], s)
        for s in R_shapes.ALL_SHAPES]
    assert [dataclasses.asdict(s) for s in shapes.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in R_shapes.ALL_SHAPES]


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_param_layout_equals_reference(arch):
    """``reference_param_shapes`` == ``jax.eval_shape(init_params)``, at
    the published and at the reduced widths."""
    for cfg in (registry.ARCHS[arch], registry.reduced_config(arch)):
        want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                     ref_cfg(cfg)))
        want = jax.tree_util.tree_map(
            lambda s: (tuple(s.shape), str(s.dtype)), want)
        assert convert.reference_param_shapes(cfg) == want


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_from_reference_takes_the_reference_init(arch):
    """The reference's own ``jax.random`` parameters (bf16 and f32 leaves)
    map onto the port bit for bit, and the port runs on them."""
    cfg = registry.reduced_config(arch)
    params = jax.jit(RT.init_params, static_argnums=1)(jax.random.PRNGKey(3),
                                                       ref_cfg(cfg))
    got = convert.from_reference(cfg, params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, want in flat:
        t = got
        for k in path:
            t = t[k.key]
        assert str(t.dtype) == "torch." + str(want.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want, np.float32))
    batch = _port_batch(convert.numpy_batch(cfg, 1, 8, 0))
    logits, _, _ = PT.forward_full(got, cfg, batch)
    assert logits.shape[-1] == cfg.padded_vocab
    assert torch.isfinite(logits.float()).all()


def test_from_reference_refuses_a_wrong_tree():
    cfg = registry.reduced_config("qwen1.5-0.5b")
    tree = convert.numpy_params(cfg, 0)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq: shape"):
        convert.from_reference(cfg, tree)
    del tree["layers"]["attn"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        convert.from_reference(cfg, tree)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_inputs_match_the_reference_shapes(arch):
    cfg = registry.reduced_config(arch)
    want = jax.eval_shape(lambda: R_inputs.make_train_batch(
        jax.random.PRNGKey(0), ref_cfg(cfg), 3, 24))
    got = P_inputs.make_train_batch(torch.Generator().manual_seed(0), cfg,
                                    3, 24)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert P_inputs.prefix_len(cfg, 24) == R_inputs.prefix_len(
        ref_cfg(cfg), 24)
    nb = convert.numpy_batch(cfg, 3, 24, 0)
    assert {k: v.shape for k, v in nb.items()} == {
        k: v.shape for k, v in want.items() if k != "labels"}
    dec = P_inputs.make_decode_inputs(torch.Generator().manual_seed(0), cfg,
                                      3, 24, 7)
    want_dec = jax.eval_shape(lambda: RT.init_cache(ref_cfg(cfg), 3, 24))
    assert jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  want_dec) == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        dec["cache"])
    assert dec["token"].shape == (3, 1) and dec["cur_pos"] == 7


# -------------------------------------------------------- forward, decode
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_prefill_logits_and_cache_match_reference(arch, runs,
                                                  record_property):
    cfg, tree, batch, (_, logits, caches) = runs(arch)
    params = convert.from_reference(cfg, tree)
    got, aux, cache = PT.forward_full(params, cfg, _port_batch(batch),
                                      collect_cache=True, cache_len=S + STEPS)
    record_property("share_of_tol", max(
        _err(got, logits[0], F32_TOL, "prefill logits"),
        _tree_err(cache, caches[0], F32_TOL, "prefill cache")))
    if cfg.moe.n_experts:
        assert float(aux) > 0


@pytest.mark.parametrize("cache_kind", ["prefill", "fresh_bf16"])
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_decode_step_matches_reference(arch, cache_kind, runs,
                                      record_property):
    """One ``forward_decode`` on the same token and cache: the reference's
    prefill cache, or ``init_cache``'s default bf16 zeros at position 5."""
    cfg, tree, batch, (tokens, logits, caches) = runs(arch)
    params = convert.from_reference(cfg, tree)
    tok = tokens[:, :1]
    if cache_kind == "prefill":
        ref_cache, pos = caches[0], S
        want_logits, want_cache = logits[1], caches[1]
    else:
        rcfg = ref_cfg(cfg)
        ref_cache, pos = RT.init_cache(rcfg, B, S + STEPS), 5
        want_logits, want_cache = jax.jit(
            lambda p, t, c: RT.forward_decode(p, rcfg, t, c, jnp.int32(pos)))(
            jax_params(cfg, tree), jnp.asarray(tok), ref_cache)
        want_logits = np.asarray(want_logits, np.float32)
    cache = convert.from_reference(cfg, jax.tree_util.tree_map(
        np.asarray, ref_cache))
    got, cache_out = PT.forward_decode(params, cfg, torch.from_numpy(tok),
                                       cache, pos)
    assert cache_out is cache                       # updated in place
    record_property("share_of_tol", max(
        _err(got, want_logits, F32_TOL, f"decode logits ({cache_kind})"),
        _tree_err(cache, want_cache, F32_TOL, f"decode cache ({cache_kind})")))


@pytest.mark.parametrize("arch", ["gemma3-1b", "hymba-1.5b"])
def test_long_prompt_takes_the_banded_path(arch, record_property,
                                          monkeypatch):
    """A 512-token prompt with a narrow window, so local layers take the
    banded (block-skipping) path, as the reference's static windows do:
    gemma3-1b with 7 layers (five local, one global, one leftover local
    after the period) and hymba-1.5b, f32, prefill and one decode step."""
    from repro_torch.models import attention as P_attn
    banded = []
    real = P_attn.flash_attention_banded
    monkeypatch.setattr(P_attn, "flash_attention_banded",
                        lambda *a, **k: banded.append(k["window"])
                        or real(*a, **k))
    cfg = f32(registry.reduced_config(arch))
    cfg = dataclasses.replace(cfg, sliding_window=16, n_layers=(
        7 if arch == "gemma3-1b" else cfg.n_layers))
    assert list(PT.layer_windows(cfg)) == (
        [16] * 5 + [0, 16] if arch == "gemma3-1b" else [16, 16])
    tree = convert.numpy_params(cfg, fixtures.SEED_PARAMS)
    batch = convert.numpy_batch(cfg, 1, 512, fixtures.SEED_INPUTS)
    tokens, logits, caches = ref_run(cfg, tree, batch, 512, 1)
    params = convert.from_reference(cfg, tree)
    got, _, cache = PT.forward_full(params, cfg, _port_batch(batch),
                                    collect_cache=True, cache_len=513)
    assert banded == [16] * (6 if arch == "gemma3-1b" else 2)
    share = _err(got, logits[0], F32_TOL, "prefill logits")
    dec, _ = PT.forward_decode(params, cfg, torch.from_numpy(tokens[:, :1]),
                               cache, 512)
    share = max(share, _err(dec, logits[1], F32_TOL, "decode logits"),
                _tree_err(cache, caches[1], F32_TOL, "decode cache"))
    record_property("share_of_tol", share)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_greedy_tokens_equal_reference(arch, runs):
    """``make_prefill_step`` then 4 ``make_decode_step`` calls: every token
    == the reference's greedy tokens."""
    cfg, tree, batch, (tokens, _, _) = runs(arch)
    params = convert.from_reference(cfg, tree)
    prefill = P_steps.make_prefill_step(cfg, cache_len=S + STEPS)
    decode = P_steps.make_decode_step(cfg)
    with torch.inference_mode():
        tok, cache = prefill(params, _port_batch(batch))
        got = [tok]
        for i in range(STEPS):
            tok, cache = decode(params, tok, cache, S + i)
            got.append(tok)
    got = torch.cat(got, dim=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tokens)


@pytest.mark.parametrize("arch", [a for a in ARCH_LIST if a not in MOE_ARCHS])
def test_bf16_logits_within_tolerance(arch, record_property):
    """The configs' own bf16 params and compute: prefill logits, then one
    decode step from each side's own cache on the same token."""
    cfg = registry.reduced_config(arch)
    tree = convert.numpy_params(cfg, fixtures.SEED_PARAMS)
    batch = convert.numpy_batch(cfg, B, S, fixtures.SEED_INPUTS)
    _, want, _ = ref_run(cfg, tree, batch, S, 1)
    params = convert.from_reference(cfg, tree)
    logits, _, cache = PT.forward_full(params, cfg, _port_batch(batch),
                                       collect_cache=True, cache_len=S + 1)
    tok = torch.argmax(torch.from_numpy(want[0][:, -1:]), dim=-1).to(
        torch.int32)
    dec, _ = PT.forward_decode(params, cfg, tok, cache, S)
    assert logits.dtype == torch.bfloat16
    for got, ref, what in ((logits, want[0], "prefill"),
                           (dec, want[1], "decode")):
        tol = BF16_ULPS * 2.0 ** -7 * float(np.abs(ref).max())
        err = float(np.abs(got.float().numpy() - ref).max())
        record_property(f"{what}_share_of_tol", err / tol)
        assert err <= tol, f"bf16 {what}: {err:.3g} > {tol:.3g} " \
            f"({err / tol:.2f} of the bound)"


def test_lm_loss_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 40), dtype=np.float32) * 3
    labels = rng.integers(-1, 40, (2, 9)).astype(np.int32)
    want = float(jax.jit(RT.lm_loss, static_argnums=2)(
        jnp.asarray(logits), jnp.asarray(labels), 40))
    got = float(PT.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


# ---------------------------------------------------------------- fixture
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_port_matches_committed_fixture(arch):
    """The same comparison ``chip_smoke.py`` phase 11 makes on the card:
    the port's greedy run against ``reference_serve.json``."""
    case = next(c for c in fixtures.serve_cases() if c.name == arch)
    entry = fixtures.load()["cases"][arch]
    params = convert.from_reference(
        case.cfg, convert.numpy_params(case.cfg, fixtures.SEED_PARAMS))
    tokens, logits = fixtures.greedy_run(params, case)
    res = fixtures.compare(entry, tokens, logits)
    assert res["ok"], res


def test_fixture_states_its_cases():
    doc = fixtures.load()
    cases = fixtures.serve_cases()
    assert sorted(doc["cases"]) == sorted(c.name for c in cases)
    for c in cases:
        e = doc["cases"][c.name]
        assert (e["arch"], e["n_layers"], e["batch"], e["prompt_len"],
                e["decode_steps"]) == (c.cfg.arch_id, c.cfg.n_layers,
                                       c.batch, c.prompt_len, c.steps)
        assert np.asarray(e["tokens"]).shape == (c.batch, 1 + c.steps)
    g = next(c for c in cases if not c.full_logits)
    assert (g.cfg.d_model, g.cfg.d_ff, g.cfg.vocab_size, g.cfg.head_dim) == (
        1152, 6912, 262_144, 256)
    assert list(PT.layer_windows(g.cfg)) == [512] * 5 + [0]
    assert g.prompt_len > g.cfg.sliding_window
    # the regeneration ran the port on the CPU too and recorded its miss
    assert all(r["ok"] for r in doc["cpu_port_check"].values())


# ----------------------------------------------------------------- the CLI
def test_serve_cli_runs_on_the_cpu_when_asked():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--device", "cpu", "--arch", "hymba-1.5b",
                         "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[serve]")]
    assert rc == 0 and len(lines) == 2, buf.getvalue()
    assert lines[0].startswith("[serve] arch=hymba-1.5b batch=2 prefill=")
    assert lines[0].endswith("tok/s)")
    assert lines[1].startswith("[serve] sample tokens: [")


def test_serve_cli_refuses_model_parallel(capsys):
    """``--model-parallel 2`` is no longer refused: one process runs it on
    the reference's host mesh, (1, 1) over one rank, as the reference does
    on one jax device, and serves the tokens of ``--model-parallel 1``."""
    args = ["--device", "cpu", "--gen", "4", "--prompt-len", "16"]
    docs = []
    for mp in ("1", "2"):
        assert serve.main(args + ["--model-parallel", mp]) == 0
        out = capsys.readouterr().out
        docs.append(json.loads(next(line for line in out.splitlines()
                                    if line.startswith("{"))))
    assert docs[1]["mesh"] == {"data": 1, "model": 1}
    assert docs[1]["tokens"] == docs[0]["tokens"]
    for doc in docs:               # the model path reaches no kernel
        assert doc["kernel_launches"] and not any(
            doc["kernel_launches"].values())


# ------------------------------------------------------------ regenerate
def regenerate():
    doc = {"about": "reference serving outputs (repro.models.transformer, "
                    "jax on the CPU) for repro_torch.models.fixtures",
           "jax_version": jax.__version__,
           "seed_params": fixtures.SEED_PARAMS,
           "seed_inputs": fixtures.SEED_INPUTS,
           "logits_tol": fixtures.LOGITS_TOL,
           "cases": {}, "cpu_port_check": {}}
    for case in fixtures.serve_cases():
        tree = convert.numpy_params(case.cfg, fixtures.SEED_PARAMS)
        batch = convert.numpy_batch(case.cfg, case.batch, case.prompt_len,
                                    fixtures.SEED_INPUTS)
        tokens, logits, _ = ref_run(case.cfg, tree, batch, case.prompt_len,
                                    case.steps)
        entry = fixtures.record(case, tokens, [lg[:, -1] for lg in logits])
        del logits
        port_tokens, port_logits = fixtures.greedy_run(
            convert.from_reference(case.cfg, tree), case)
        check = fixtures.compare(entry, port_tokens, port_logits)
        print(case.name, json.dumps(check), flush=True)
        if not check["ok"]:
            raise SystemExit(f"the port disagrees with the reference on "
                             f"{case.name}: {check}")
        doc["cases"][case.name] = entry
        doc["cpu_port_check"][case.name] = check
    fixtures.FIXTURE.parent.mkdir(exist_ok=True)
    fixtures.FIXTURE.write_text(json.dumps(doc, separators=(",", ":")) + "\n")
    print("wrote", fixtures.FIXTURE)


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        raise SystemExit("usage: python tests/test_torch_serve.py "
                         "--regenerate")
    regenerate()
