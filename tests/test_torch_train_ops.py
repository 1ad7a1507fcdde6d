"""The pieces of the port's training path against the reference's, on the
CPU: the optimizer, the compressions, the flash-attention backward, remat
and the gradients where a max or a top-k ties.

Each test feeds the same seeded numpy inputs to a function of the JAX
package (``jax.jit`` on the CPU) and to its twin in ``repro_torch``.
Tolerances, as max |port - reference|, each reported beside its bound:

* ``OPT_TOL`` = 1e-6 times max(1, |reference|) for the optimizer and
  compression state (both sides run the same f32 operations one by one;
  XLA's ``pow`` and ``cos`` may differ from torch's by an ulp);
* ``GRAD_TOL`` = 1e-5 times the largest |gradient| of each input for the
  attention backward and the tie cases (f32 sums in other orders; the
  misses measured are below 3e-7 of that scale);
* ``==`` for remat: the three modes compute the same operations on the
  CPU, so their losses and gradients are identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.configs import base as R_base
from repro.models import attention as R_attn
from repro.models import moe as R_moe
from repro.models import ssm as R_ssm
from repro.optim import adamw as R_adamw
from repro.optim import compression as R_comp

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.models import attention as P_attn
from repro_torch.models import convert
from repro_torch.models import moe as P_moe
from repro_torch.models import ssm as P_ssm
from repro_torch.optim import adamw as P_adamw
from repro_torch.optim import compression as P_comp
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.train import fixtures as train_fixtures
from repro_torch.train import steps as P_steps

OPT_TOL = 1e-6
GRAD_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _err(got, want, bound, what):
    """Asserts max |got - want| <= bound; returns the share of the bound."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= bound, \
        f"{what}: max |port - reference| {err:.3g} > {bound:.3g}"
    return err / bound if bound else 0.0


def _opt_err(got, want, what):
    return _err(got, want, OPT_TOL * max(1.0, float(np.abs(_np(want)).max(
        initial=0.0))), what)


def _grad_err(got, want, what):
    return _err(got, want, GRAD_TOL * max(float(np.abs(_np(want)).max(
        initial=0.0)), 1e-30), what)


def _ref_tc(tc):
    return R_base.TrainConfig(**dataclasses.asdict(tc))


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


# ------------------------------------------------------------------ AdamW
def _opt_tree(rng):
    """A parameter-like tree: a stacked (L, d) norm weight (decayed), a
    top-level (d,) norm weight (not decayed), stacked matrices, a bias."""
    return {
        "final_norm": {"w": rng.standard_normal(8, dtype=np.float32)},
        "layers": {"norm": {"w": rng.standard_normal((3, 8),
                                                     dtype=np.float32)},
                   "wq": rng.standard_normal((3, 8, 2, 4), dtype=np.float32),
                   "b": rng.standard_normal((3, 5), dtype=np.float32)},
        "embed": rng.standard_normal((16, 8), dtype=np.float32) * 0.02,
    }


def _both_tree(tree, dtype):
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    tt = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), tree)
    return jt, tt


@pytest.mark.parametrize("tc", [
    TrainConfig(warmup_steps=3, total_steps=12),
    TrainConfig(warmup_steps=1, total_steps=1),
    TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=7),
], ids=["warmup+cosine", "one_step", "no_warmup"])
def test_lr_schedule_matches_reference(tc):
    """Every step of the warm-up, the cosine and past its end."""
    steps = np.arange(tc.total_steps + 3, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: R_adamw.lr_schedule(
        _ref_tc(tc), s))(jnp.asarray(steps)))
    got = torch.stack([P_adamw.lr_schedule(tc, torch.tensor(int(s),
                                                            dtype=torch.int32))
                       for s in steps])
    assert got.dtype == torch.float32
    _opt_err(got, want, "lr")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype):
    rng = np.random.default_rng(0)
    tree = _opt_tree(rng)
    jt, tt = _both_tree(tree, dtype)
    for max_norm in (0.5, 1.0, 1e3):
        cj, nj = jax.jit(R_adamw.clip_by_global_norm,
                         static_argnums=1)(jt, max_norm)
        ct, nt = P_adamw.clip_by_global_norm(tt, max_norm)
        _opt_err(nt, nj, "global norm")
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(cj),
                                leaves(ct)):
            assert b.dtype == getattr(torch, dtype)
            _opt_err(b, a, f"clipped {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Four steps carrying the moments, clipping active on some: the new
    parameters (in their dtype), the f32 moments, grad_norm and lr."""
    rng = np.random.default_rng(1)
    tree = _opt_tree(rng)
    pj, pt = _both_tree(tree, dtype)
    tc = TrainConfig(warmup_steps=2, total_steps=6, learning_rate=1e-2)
    mj, mt = R_adamw.init_moments(pj), P_adamw.init_moments(pt)
    upd = jax.jit(lambda p, g, m, s: R_adamw.adamw_update(p, g, m, s,
                                                          _ref_tc(tc)))
    for step in range(4):
        gtree = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape, dtype=np.float32)
            * (3.0 if step % 2 else 0.01), tree)
        gj, gt = _both_tree(gtree, dtype)
        pj, mj, oj = upd(pj, gj, mj, jnp.int32(step))
        pt, mt, ot = P_adamw.adamw_update(pt, gt, mt, torch.tensor(
            step, dtype=torch.int32), tc)
        for k in ("grad_norm", "lr"):
            _opt_err(ot[k], oj[k], k)
        for name, a, b in (("params", pj, pt), ("m", mj["m"], mt["m"]),
                           ("v", mj["v"], mt["v"])):
            for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                                    leaves(b)):
                assert str(y.dtype).endswith(str(x.dtype))
                # bf16: the clip scale is cast to bf16, and an f32 norm one
                # ulp apart may round it the other way, moving every
                # gradient of the step by a bf16 ulp; the parameters
                # round to bf16 too: one bf16 ulp of the leaf's scale
                bound = OPT_TOL if dtype == "float32" else 2.0 ** -7
                _err(y, x, bound * max(1.0, float(np.abs(_np(x)).max())),
                     f"step {step} {name}{jax.tree_util.keystr(path)}")


def test_weight_decay_goes_to_stacked_leaves():
    """With zero gradients only the decay moves a parameter: every leaf of
    ndim >= 2 of the stacked tree (the (L, d) norm weight and the (L, n)
    bias too), never the top-level (d,) final norm -- as the reference."""
    rng = np.random.default_rng(2)
    tree = _opt_tree(rng)
    pj, pt = _both_tree(tree, "float32")
    zj, zt = _both_tree(jax.tree_util.tree_map(np.zeros_like, tree),
                        "float32")
    tc = TrainConfig(warmup_steps=1, total_steps=4)
    nj, _, _ = jax.jit(lambda p, g: R_adamw.adamw_update(
        p, g, R_adamw.init_moments(p), jnp.int32(0), _ref_tc(tc)))(pj, zj)
    nt, _, _ = P_adamw.adamw_update(pt, zt, P_adamw.init_moments(pt),
                                    torch.tensor(0, dtype=torch.int32), tc)
    moved = {jax.tree_util.keystr(p): not np.array_equal(np.asarray(a), b)
             for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(nj),
                                  jax.tree_util.tree_leaves(tree))}
    assert moved == {"['embed']": True, "['final_norm']['w']": False,
                     "['layers']['b']": True, "['layers']['norm']['w']": True,
                     "['layers']['wq']": True}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(nj),
                            leaves(nt)):
        _opt_err(b, a, f"decayed {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("method", ["none", "bf16", "int8_ef"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_matches_reference(method, dtype):
    """Three rounds carrying the error feedback.  The int8 scale is the
    max-abs over 127 and the rounding is half to even: the first round's
    leaf holds exact .5 multiples of its scale."""
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng)
    # max |g| = 127, so the scale is exactly 1 and k + 0.5 ties
    tree["layers"]["b"] = np.array(
        [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 4.5, -3.5, 0.25, -126.5,
         126.5, 5.5, -5.5], np.float32).reshape(3, 5)
    gj, gt = _both_tree(tree, dtype)
    ej = R_comp.init_error_feedback(gj) if method == "int8_ef" else None
    et = P_comp.init_error_feedback(gt) if method == "int8_ef" else None
    comp = jax.jit(lambda g, e: R_comp.compress_grads(g, method, e))
    for rnd in range(3):
        cj, ej = comp(gj, ej)
        ct, et = P_comp.compress_grads(gt, method, et)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(cj),
                                leaves(ct)):
            assert str(b.dtype).endswith(str(a.dtype)), (path, b.dtype)
            _opt_err(b, a, f"round {rnd} {jax.tree_util.keystr(path)}")
        if method == "int8_ef":
            for a, b in zip(jax.tree_util.tree_leaves(ej), leaves(et)):
                assert b.dtype == torch.bfloat16
                _err(b, a, 2.0 ** -8 * max(1e-3, float(np.abs(
                    _np(a)).max())), f"round {rnd} error feedback")
        gtree = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape, dtype=np.float32), tree)
        gj, gt = _both_tree(gtree, dtype)


def test_int8_ef_needs_its_error_feedback():
    with pytest.raises(ValueError, match="error_fb"):
        P_comp.compress_grads({"w": torch.ones(2)}, "int8_ef", None)
    with pytest.raises(ValueError, match="unknown compression"):
        P_comp.compress_grads({"w": torch.ones(2)}, "fp8")


# ------------------------------------------------------- flash backward
FLASH_CASES = {
    # name: (B, Sq, Skv, H, Hkv, dh, function, kwargs)
    "causal": (2, 40, 40, 4, 4, 8, "jnp", dict(causal=True, block=16)),
    "window": (2, 40, 40, 4, 4, 8, "jnp", dict(causal=True, window=7,
                                               block=16)),
    "q_offset": (1, 10, 50, 4, 4, 8, "jnp", dict(causal=True, q_offset=40,
                                                 block=16)),
    "kv_len": (1, 12, 50, 4, 4, 8, "jnp", dict(causal=False, kv_len=33,
                                               block=16)),
    "ragged_blk": (2, 37, 37, 4, 2, 8, "jnp", dict(causal=True, block=16)),
    "gqa": (2, 33, 33, 8, 2, 16, "jnp", dict(causal=True, window=9,
                                             block=8)),
    "banded": (1, 96, 96, 4, 1, 8, "banded", dict(window=20, block=16)),
    "banded_nband_ge_nq": (1, 48, 48, 2, 2, 8, "banded",
                           dict(window=40, block=16)),
}


def _flash_fns(name):
    *_, kind, kw = FLASH_CASES[name]
    if kind == "banded":
        return (lambda q, k, v: R_attn.flash_attention_banded(q, k, v, **kw),
                lambda q, k, v: P_attn.flash_attention_banded(q, k, v, **kw))
    return (lambda q, k, v: R_attn.flash_attention_jnp(q, k, v, **kw),
            lambda q, k, v: P_attn.flash_attention_jnp(q, k, v, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_gradients_match_reference(name, dtype):
    """d/d(q, k, v) of <attention(q, k, v), g> against ``jax.grad`` of the
    reference's function (its ``custom_vjp``), in the inputs' dtype."""
    B, Sq, Skv, H, Hkv, dh, kind, kw = FLASH_CASES[name]
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal(s, dtype=np.float32) for s in (
        (B, Sq, H, dh), (B, Skv, Hkv, dh), (B, Skv, Hkv, dh), (B, Sq, H, dh))]
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    fj, fp = _flash_fns(name)
    want = jax.jit(jax.grad(lambda q, k, v, g: jnp.sum(
        (fj(q, k, v) * g).astype(jnp.float32)), argnums=(0, 1, 2)))(*jx)
    ins = [t.clone().requires_grad_(True) for t in tx[:3]]
    torch.sum((fp(*ins) * tx[3]).float()).backward()
    for x, w, what in zip(ins, want, "qkv"):
        assert x.grad.dtype == x.dtype
        if dtype == "float32":
            _grad_err(x.grad, w, f"d{what}")
        else:
            # the same bf16 cotangent and casts on both sides; the f32
            # sums round to bf16 at the end: within two bf16 ulps
            _err(x.grad, w, 2 * 2.0 ** -7 * float(np.abs(_np(w)).max()),
                 f"bf16 d{what}")


def test_banded_backward_sums_overlapping_bands():
    """The band of each q block overlaps its neighbours' (nband < nq): the
    port's banded path really loops q blocks here, and autograd sums each
    key's gradient over the bands that hold it."""
    B, S, H, dh = 1, 96, 4, 8
    window, block = 20, 16
    blk = min(block, S, max(window, 128))
    while S % blk:
        blk //= 2
    nq, nband = S // blk, min(-(-window // blk) + 1, S // blk)
    assert 1 < nband < nq
    calls = []
    orig = P_attn._Flash.apply

    def spy(*args):
        calls.append(args[0].shape[1])
        return orig(*args)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, H if i == 0 else 1, dh), dtype=np.float32)).requires_grad_(True)
        for i in range(3))
    P_attn._Flash.apply = spy
    try:
        P_attn.flash_attention_banded(q, k, v, window=window,
                                      block=block).sum().backward()
    finally:
        P_attn._Flash.apply = orig
    assert calls == [blk] * nq
    full = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    P_attn.flash_attention_jnp(*full, causal=True, window=window,
                               block=block).sum().backward()
    for a, b, what in zip((q, k, v), full, "qkv"):
        _grad_err(a.grad, b.grad, f"banded vs masked d{what}")


def test_flash_gradcheck_f64():
    """``torch.autograd.gradcheck`` of the Function in f64 (the products
    stay f64) against finite differences: windowed causal, ragged kv with
    an offset and GQA, and the banded path."""
    g = torch.Generator().manual_seed(0)

    def inputs(B, Sq, Skv, H, Hkv, dh):
        return tuple(torch.randn(s, dtype=torch.float64, generator=g,
                                 requires_grad=True)
                     for s in ((B, Sq, H, dh), (B, Skv, Hkv, dh),
                               (B, Skv, Hkv, dh)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: P_attn.flash_attention_jnp(
            q, k, v, causal=True, window=3, block=4), inputs(1, 6, 6, 2, 1, 4))
    assert torch.autograd.gradcheck(
        lambda q, k, v: P_attn.flash_attention_jnp(
            q, k, v, causal=False, kv_len=5, q_offset=2, block=4),
        inputs(1, 3, 7, 4, 2, 4))
    assert torch.autograd.gradcheck(
        lambda q, k, v: P_attn.flash_attention_banded(q, k, v, window=4,
                                                      block=4),
        inputs(1, 16, 16, 2, 1, 4))


def test_flash_softcap_backward_matches_reference():
    """The reference's backward recomputes the scores without the
    softcap's tanh (``_flash_bwd``); the port's does the same, so with a
    softcap both give the same (not the exact) gradient."""
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal(s, dtype=np.float32) * 3 for s in (
        (1, 20, 2, 8), (1, 20, 2, 8), (1, 20, 2, 8))]
    kw = dict(causal=True, block=8, softcap=5.0)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(R_attn.flash_attention_jnp(
        q, k, v, **kw)), argnums=(0, 1, 2)))(*map(jnp.asarray, arrays))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    P_attn.flash_attention_jnp(*ins, **kw).sum().backward()
    for x, w, what in zip(ins, want, "qkv"):
        _grad_err(x.grad, w, f"softcap d{what}")


# ------------------------------------------------------------------ remat
def _arch_batch(cfg):
    b = train_fixtures.numpy_train_batch(cfg, 2, 32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_remat_modes_give_equal_losses_and_gradients(arch):
    cfg = _f32(registry.reduced_config(arch))
    params = convert.from_reference(cfg, convert.numpy_params(cfg, 0))
    batch = _arch_batch(cfg)
    runs = {r: P_steps.grads_and_loss(params, cfg, batch, remat=r)
            for r in ("none", "block", "full")}
    g0, l0, a0 = runs["none"]
    for r in ("block", "full"):
        g, l, a = runs[r]
        assert torch.equal(l, l0) and torch.equal(a, a0), r
        assert all(torch.equal(x, y) for x, y in zip(leaves(g), leaves(g0)))


def _backward_products(cfg, params, batch, remat):
    """(products with no batch dimension, batched products) that the
    backward pass of ``remat`` runs: the recomputed ones and the gradient
    products."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = {"no_batch": 0, "batched": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                key = ("no_batch" if func == torch.ops.aten.mm.default
                       or args[0].shape[0] == 1 else "batched")
                counts[key] += 1
            return func(*args, **(kwargs or {}))
    req = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, _ = P_steps.loss_fn(req, cfg, batch, remat=remat)
    with Count():
        total.backward()
    return counts


def test_block_remat_keeps_the_products_without_batch_dims():
    """``"block"`` recomputes the batched products (attention's) in the
    backward pass and none of the projections; ``"full"`` recomputes
    both; ``"none"`` neither.  (B=1 here would make the attention
    products look batch-free; this config has 2 rows and 2 KV heads.)"""
    cfg = _f32(registry.reduced_config("qwen1.5-0.5b"))
    params = convert.from_reference(cfg, convert.numpy_params(cfg, 0))
    batch = _arch_batch(cfg)
    c = {r: _backward_products(cfg, params, batch, r)
         for r in ("none", "block", "full")}
    assert c["block"]["no_batch"] == c["none"]["no_batch"]
    assert c["block"]["batched"] > c["none"]["batched"]
    assert c["full"]["no_batch"] > c["none"]["no_batch"]
    assert c["full"]["batched"] == c["block"]["batched"]


# ------------------------------------------------------------------- ties
def test_cummax_gradient_splits_ties_as_the_reference():
    """``ssm.cummax`` is ``lax.cummax`` differentiated as JAX does (its
    parallel prefix scan); ``torch.cummax`` would send a tied cotangent to
    one index."""
    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 5, 16, 17):
        x = rng.integers(0, 3, (3, n, 2)).astype(np.float32)
        w = rng.standard_normal((3, n, 2)).astype(np.float32)
        want = jax.grad(lambda a: jnp.sum(jax.lax.cummax(a, axis=1) * w))(
            jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_(True)
        got = P_ssm.cummax(t, 1)
        assert torch.equal(got, torch.cummax(torch.from_numpy(x), 1).values)
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def test_recurrence_gradients_with_forced_ties():
    """mLSTM (chunked) and sLSTM with the forget gate saturated (log gate
    exactly 0) and integer input gates: the chunk's ``cummax`` and ``max``
    and the cell's ``maximum`` all tie, and the cotangents split as the
    reference's do."""
    rng = np.random.default_rng(8)
    B, S, H, dh = 1, 12, 2, 4
    q, k, v = (rng.standard_normal((B, S, H, dh), dtype=np.float32)
               for _ in range(3))
    i_raw = rng.integers(-1, 2, (B, S, H)).astype(np.float32)
    f_raw = np.full((B, S, H), 200.0, np.float32)
    arrays = (q, k, v, i_raw, f_raw)

    def ref(*xs):
        h, st = R_ssm.mlstm_sequence(*xs, chunk=4)
        return jnp.sum(h * 1.5) + jnp.sum(st["C"]) + jnp.sum(st["m"])
    want = jax.jit(jax.grad(ref, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, arrays))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    h, st = P_ssm.mlstm_sequence(*ins, chunk=4)
    (torch.sum(h * 1.5) + torch.sum(st["C"]) + torch.sum(st["m"])).backward()
    for x, w, what in zip(ins, want, ("q", "k", "v", "i", "f")):
        _grad_err(x.grad, w, f"mLSTM d{what}")

    cfg = _f32(registry.reduced_config("xlstm-125m"))
    from repro.configs import registry as R_registry
    rcfg = _f32(R_registry.reduced_config("xlstm-125m"))
    layout = P_ssm.slstm_layout(cfg)
    p = {kk: (np.broadcast_to(leaf.value, leaf.shape).copy()
              if leaf.init == "const" else rng.standard_normal(
                  leaf.shape, dtype=np.float32) * np.float32(leaf.scale))
         for kk, leaf in layout.items()}
    d = cfg.d_model
    # input and recurrent weights 0, forget bias huge: every step's
    # lf + m equals the constant input gate, so the maximum ties
    p["w_gates"][:] = 0.0
    p["r_gates"][:] = 0.0
    p["b_gates"][2 * d:3 * d] = 200.0
    x = rng.standard_normal((1, 6, d), dtype=np.float32)
    want = jax.jit(jax.grad(lambda pp, xx: jnp.sum(R_ssm.slstm_block(
        pp, rcfg, xx)[0]), argnums=(0, 1)))(
        {kk: jnp.asarray(a) for kk, a in p.items()}, jnp.asarray(x))
    pt = {kk: torch.from_numpy(a).requires_grad_(True) for kk, a in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    P_ssm.slstm_block(pt, cfg, xt)[0].sum().backward()
    for kk in sorted(p):
        _grad_err(pt[kk].grad, want[0][kk], f"sLSTM d{kk}")
    _grad_err(xt.grad, want[1], "sLSTM dx")


@pytest.mark.parametrize("impl", ["gather", "einsum"])
def test_router_gradients_with_tied_experts(impl):
    """Experts 0/1 and 2/3 share router columns, so every token's
    probabilities tie in pairs: top-k takes the lower expert and sends it
    the gradient, as ``lax.top_k`` does; every parameter's and the input's
    gradient matches the reference's."""
    from repro.configs import registry as R_registry
    arch = "moonshot-v1-16b-a3b"
    cfg = _f32(registry.reduced_config(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl=impl))
    rcfg = _f32(R_registry.reduced_config(arch))
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                             impl=impl))
    rng = np.random.default_rng(9)
    layout = P_moe.moe_layout(cfg)
    p = {kk: rng.standard_normal(leaf.shape, dtype=np.float32)
         * np.float32(leaf.scale) for kk, leaf in layout.items()}
    p["router"][:, 1] = p["router"][:, 0]
    p["router"][:, 3] = p["router"][:, 2]
    x = rng.standard_normal((2, 24, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal((2, 24, cfg.d_model), dtype=np.float32)

    def ref(pp, xx):
        y, aux = R_moe.moe_ffn(pp, rcfg, xx)
        return jnp.sum(y * w) + aux
    want = jax.jit(jax.grad(ref, argnums=(0, 1)))(
        {kk: jnp.asarray(a) for kk, a in p.items()}, jnp.asarray(x))
    pt = {kk: torch.from_numpy(a).requires_grad_(True) for kk, a in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = P_moe.moe_ffn(pt, cfg, xt)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    _, idx, _ = P_moe._router(pt, cfg, xt)
    assert (idx[..., 0] % 2 == 0).all(), "a tie took the higher expert"
    for kk in sorted(p):
        _grad_err(pt[kk].grad, want[0][kk], f"moe {impl} d{kk}")
    _grad_err(xt.grad, want[1], f"moe {impl} dx")


def test_masked_exponents_stay_finite():
    """The SSD chunk masks ``logw`` to -inf before ``exp`` and the padded
    mLSTM input gates are -1e30: with decays large enough that the
    unmasked non-causal ``logw`` would overflow, and a sequence that pads
    its last chunk, every gradient is finite."""
    rng = np.random.default_rng(10)
    B, S, H, dh, N = 1, 10, 2, 4, 3
    xh = torch.from_numpy(rng.standard_normal((B, S, H, dh),
                                              dtype=np.float32))
    bt, ct = (torch.from_numpy(rng.standard_normal((B, S, N),
                                                   dtype=np.float32))
              for _ in range(2))
    la = torch.full((B, S, H), -60.0)                 # exp(+600) overflows
    ins = [t.clone().requires_grad_(True) for t in (xh, bt, ct, la)]
    y, st = P_ssm.ssd_sequence(*ins, torch.zeros(B, H, dh, N), chunk=4)
    (y.sum() + st.sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in ins)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, dh),
                                                    dtype=np.float32))
               .requires_grad_(True) for _ in range(3))
    gi, gf = (torch.from_numpy(rng.standard_normal((B, S, H),
                                                   dtype=np.float32))
              .requires_grad_(True) for _ in range(2))
    h, st = P_ssm.mlstm_sequence(q, k, v, gi, gf, chunk=4)  # 10 -> pad 2
    (h.sum() + st["C"].sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v, gi, gf))
