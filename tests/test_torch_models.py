"""The port's model modules against the reference's, one function at a
time, on the CPU.

Each test feeds the same seeded numpy inputs to a function of
``repro.models`` (run through ``jax.jit`` on the CPU) and to its twin in
``repro_torch.models``.  Tolerances, as max |port - reference|:

* ``F32_TOL`` = 1e-5 times max(1, the output's largest magnitude) for f32
  paths (both sides sum the same f32 terms in other orders; the misses
  measured here are 1e-7 to 1e-5 of that scale);
* ``BF16_ULPS`` = 2 bf16 ulps of the output's largest magnitude for bf16
  paths on identical bf16 inputs (each side rounds each op once, XLA may
  keep some intermediates in f32);
* ``==`` for top-k indices, capacity drops and dispatch order.

Each assertion message reports the error beside its bound.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.configs.registry import reduced_config as ref_reduced
from repro.models import attention as R_attn
from repro.models import layers as R_layers
from repro.models import moe as R_moe
from repro.models import ssm as R_ssm

from repro_torch.configs.registry import reduced_config
from repro_torch.models import attention as P_attn
from repro_torch.models import layers as P_layers
from repro_torch.models import moe as P_moe
from repro_torch.models import ssm as P_ssm

F32_TOL = 1e-5
BF16_ULPS = 2


def _r(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale)


def _both(a, dtype="float32"):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a, dtype), torch.from_numpy(np.asarray(a)).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _check(got, want, tol, what=""):
    """|got - want| <= tol; an f32 bound is scaled by the output."""
    got, want = _np(got), _np(want)
    if tol == F32_TOL and want.size:
        tol *= max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, f"{what}: max |port - reference| {err:.3g} > {tol:.3g}"
    return err


def _bf16_tol(want):
    return BF16_ULPS * 2.0 ** -7 * float(np.abs(_np(want)).max())


def _tree(rng, layout):
    """Random arrays for a port layout (the ``Leaf`` entries)."""
    def draw(leaf):
        z = _normal(rng, *leaf.shape)
        if leaf.init == "const":
            return np.broadcast_to(leaf.value, leaf.shape) + 0.1 * z
        return z * np.float32(leaf.scale)
    out = {}
    for k, v in layout.items():
        out[k] = _tree(rng, v) if isinstance(v, dict) else draw(v)
    return out


def _convert(tree, layout, dtype=None):
    """(jax tree, torch tree) with each leaf in its layout dtype."""
    jt, tt = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            jt[k], tt[k] = _convert(v, layout[k], dtype)
        else:
            jt[k], tt[k] = _both(v, dtype or layout[k].dtype)
    return jt, tt


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


# ---------------------------------------------------- norms, rope, swiglu
def _norm_case(name, dtype):
    rng = _r(1)
    x = _normal(rng, 2, 7, 64)
    w = _normal(rng, 64, scale=0.1)
    b = _normal(rng, 64, scale=0.1)
    (xj, xt), (wj, wt), (bj, bt) = (_both(a, dtype) for a in (x, w, b))
    if name == "rms":
        return (jax.jit(R_layers.rms_norm, static_argnums=2)(xj, wj, 1e-6),
                P_layers.rms_norm(xt, wt, 1e-6))
    if name == "ln":
        return (jax.jit(R_layers.layer_norm, static_argnums=3)(xj, wj, bj,
                                                               1e-6),
                P_layers.layer_norm(xt, wt, bt, 1e-6))
    if name == "rope":
        x = _normal(rng, 2, 9, 4, 16)
        (xj, xt) = _both(x, dtype)
        pos = np.arange(100, 109)[None]
        return (jax.jit(R_layers.apply_rope, static_argnums=2)(
                    xj, jnp.asarray(pos), 1e6),
                P_layers.apply_rope(xt, torch.from_numpy(pos), 1e6))
    if name == "rope_decode":
        x = _normal(rng, 2, 1, 4, 16)
        (xj, xt) = _both(x, dtype)
        return (jax.jit(R_layers.apply_rope, static_argnums=2)(
                    xj, jnp.asarray(37)[None][None], 1e4),
                P_layers.apply_rope(xt, torch.full((1, 1), 37), 1e4))
    if name.startswith("softcap"):
        cap = 30.0 if name == "softcap" else 0.0
        (xj, xt) = _both(_normal(rng, 2, 7, 64, scale=40.0), dtype)
        return (R_layers.softcap(xj, cap), P_layers.softcap(xt, cap))
    p = {"w_gate": _normal(rng, 64, 96, scale=0.125),
         "w_up": _normal(rng, 64, 96, scale=0.125),
         "w_down": _normal(rng, 96, 64, scale=0.1)}
    pj = {k: _both(v, dtype)[0] for k, v in p.items()}
    pt = {k: _both(v, dtype)[1] for k, v in p.items()}
    return jax.jit(R_layers.swiglu)(pj, xj), P_layers.swiglu(pt, xt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["rms", "ln", "rope", "rope_decode",
                                  "swiglu", "softcap", "softcap_off"])
def test_norms_rope_swiglu_match_reference(name, dtype):
    want, got = _norm_case(name, dtype)
    assert str(got.dtype) == "torch." + str(want.dtype)
    tol = F32_TOL if dtype == "float32" else _bf16_tol(want)
    _check(got, want, tol, f"{name} {dtype}")


# -------------------------------------------------------------- attention
def _qkv(seed, B, Sq, H, Hkv, dh, Skv=None, dtype="float32"):
    rng = _r(seed)
    q = _normal(rng, B, Sq, H, dh)
    k = _normal(rng, B, Skv or Sq, Hkv, dh)
    v = _normal(rng, B, Skv or Sq, Hkv, dh)
    return [_both(a, dtype) for a in (q, k, v)]


FLASH_CASES = {
    # name: (Sq, Skv, kwargs)
    "causal": (40, 40, dict(causal=True)),
    "window": (40, 40, dict(causal=True, window=9)),
    "q_offset": (12, 40, dict(causal=True, q_offset=28)),
    "kv_len": (16, 48, dict(causal=False, kv_len=37)),
    "softcap": (40, 40, dict(causal=True, softcap=2.0)),
    "padded_block": (40, 40, dict(causal=True, window=17, block=16)),
    "all_options": (12, 48, dict(causal=True, window=20, q_offset=30,
                                 kv_len=41, block=16, softcap=3.0)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_jnp_matches_reference(case, dtype):
    Sq, Skv, kw = FLASH_CASES[case]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 2, Sq, 4, 2, 16, Skv, dtype)
    static = {k: v for k, v in kw.items() if k in ("causal", "block",
                                                   "softcap")}
    dyn = {k: v for k, v in kw.items() if k not in static}
    # the reference traces window, q_offset and kv_len (jit arguments)
    want = jax.jit(functools.partial(R_attn.flash_attention_jnp, **static))(
        qj, kj, vj, **{k: jnp.asarray(v) for k, v in dyn.items()})
    got = P_attn.flash_attention_jnp(qt, kt, vt, **kw)
    tol = F32_TOL if dtype == "float32" else _bf16_tol(want)
    _check(got, want, tol, f"flash {case} {dtype}")


BANDED_CASES = {
    # name: (S, window, block): the band is narrower than the sequence
    "banded": (256, 64, 64),
    # the band covers every q block: the full path with the band's block
    "band_covers_all": (64, 64, 1024),
    # blk = 130 is halved to 32 (320 % 130, 320 % 65), band of 6 of 10
    "ragged_blk": (320, 130, 1024),
}


@pytest.mark.parametrize("case", sorted(BANDED_CASES))
def test_flash_attention_banded_matches_reference(case):
    S, window, block = BANDED_CASES[case]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, 1, S, 2, 1, 16)
    want = jax.jit(functools.partial(R_attn.flash_attention_banded,
                                     window=window, block=block))(qj, kj, vj)
    got = P_attn.flash_attention_banded(qt, kt, vt, window=window,
                                        block=block)
    _check(got, want, F32_TOL, f"banded {case}")
    # the same function as the masked full path, to the same bound
    full = P_attn.flash_attention_jnp(qt, kt, vt, causal=True, window=window)
    _check(got, full, F32_TOL, f"banded {case} against the full path")


@pytest.mark.parametrize("window", ["static", "traced"])
def test_flash_dispatch_takes_the_reference_branch(window):
    """A static int window takes the banded path, a 0-dim tensor (the
    reference's traced window) the masked full path; each agrees with
    the reference's dispatch given the same kind of window."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(6, 1, 256, 2, 1, 16)
    if window == "static":
        want = jax.jit(functools.partial(R_attn.flash_dispatch, causal=True,
                                         window=64, block=64))(qj, kj, vj)
        got = P_attn.flash_dispatch(qt, kt, vt, causal=True, window=64,
                                    block=64)
    else:
        want = jax.jit(functools.partial(R_attn.flash_dispatch, causal=True,
                                         block=64))(qj, kj, vj,
                                                    window=jnp.int32(64))
        got = P_attn.flash_dispatch(qt, kt, vt, causal=True,
                                    window=torch.tensor(64), block=64)
    _check(got, want, F32_TOL, f"dispatch {window}")


@pytest.mark.parametrize("case", ["full", "window", "softcap",
                                  "bf16_cache", "past_end"])
def test_attend_cache_matches_reference(case):
    rng = _r(7)
    B, Smax, H, Hkv, dh = 2, 48, 4, 2, 16
    q = _normal(rng, B, 1, H, dh)
    ck, cv = _normal(rng, B, Smax, Hkv, dh), _normal(rng, B, Smax, Hkv, dh)
    cdt = "bfloat16" if case == "bf16_cache" else "float32"
    (qj, qt), (kj, kt), (vj, vt) = (_both(q), _both(ck, cdt), _both(cv, cdt))
    kw = dict(window=10 if case == "window" else 0,
              softcap=5.0 if case == "softcap" else 0.0)
    cur = 60 if case == "past_end" else 20
    want = jax.jit(functools.partial(R_attn.attend_cache,
                                     softcap=kw["softcap"]))(
        qj, kj, vj, jnp.asarray(cur), window=jnp.asarray(kw["window"]))
    got = P_attn.attend_cache(qt, kt, vt, cur, **kw)
    _check(got, want, F32_TOL, f"attend_cache {case}")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma3-1b"])
def test_self_attention_decode_writes_the_cache_as_the_reference(arch):
    cfg, rcfg = _f32(reduced_config(arch)), _f32(ref_reduced(arch))
    rng = _r(8)
    p = _tree(rng, P_attn.attn_layout(cfg))
    pj, pt = _convert(p, P_attn.attn_layout(cfg))
    x = _normal(rng, 2, 1, cfg.d_model)
    ck = _normal(rng, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    cv = _normal(rng, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    want, (wk, wv) = jax.jit(
        lambda p, x, k, v: R_attn.self_attention_decode(
            p, rcfg, x, k, v, jnp.int32(13), window=jnp.int32(8)))(
        pj, jnp.asarray(x), jnp.asarray(ck, jnp.bfloat16),
        jnp.asarray(cv, jnp.bfloat16))
    kt = torch.from_numpy(ck).to(torch.bfloat16)
    vt = torch.from_numpy(cv).to(torch.bfloat16)
    got = P_attn.self_attention_decode(pt, cfg, torch.from_numpy(x), kt, vt,
                                       13, torch.full((1, 1), 13), window=8)
    _check(got, want, F32_TOL, "decode output")
    # the cache row is rounded to the cache's bf16 exactly as the reference
    np.testing.assert_array_equal(_np(kt), _np(wk))
    np.testing.assert_array_equal(_np(vt), _np(wv))


# -------------------------------------------------------------------- MoE
def _moe_case(arch, impl, case, dtype="float32"):
    # the reduced archs have no shared expert: the "shared" case adds one
    shared = int(case == "shared")
    base = reduced_config(arch)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl=impl, n_shared_experts=shared))
    rcfg = dataclasses.replace(ref_reduced(arch), moe=dataclasses.replace(
        ref_reduced(arch).moe, impl=impl, n_shared_experts=shared))
    if dtype == "float32":
        cfg, rcfg = _f32(cfg), _f32(rcfg)
    rng = _r(9)
    layout = P_moe.moe_layout(cfg)
    p = _tree(rng, layout)
    x = _normal(rng, 2, 24, cfg.d_model)
    if case == "tie":
        # experts 0 and 1 (and 2 and 3) get the same router column: every
        # token's probabilities tie in pairs, and top-k must take the
        # lower expert of a pair first
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
    if case == "over_capacity":
        # every token prefers expert 2: the group overflows its capacity
        p["router"] = p["router"] * 0.01
        p["router"][:, 2] += 1.0
        x = np.abs(x) + 1.0
    pj, pt = _convert(p, layout)
    xj, xt = _both(x, cfg.compute_dtype)
    want, aux_w = jax.jit(lambda p, x: R_moe.moe_ffn(p, rcfg, x))(pj, xj)
    got, aux_g = P_moe.moe_ffn(pt, cfg, xt)
    return cfg, (pj, xj, want, aux_w), (pt, xt, got, aux_g)


@pytest.mark.parametrize("case", ["random", "tie", "over_capacity",
                                  "shared"])
@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "moonshot-v1-16b-a3b"])
def test_moe_matches_reference(arch, impl, case):
    cfg, (pj, xj, want, aux_w), (pt, xt, got, aux_g) = _moe_case(arch, impl,
                                                                 case)
    _check(got, want, F32_TOL, f"moe {impl} {case}")
    _check(aux_g, aux_w, F32_TOL, "aux loss")
    # the routing itself, index for index
    gw, iw, _ = jax.jit(lambda p, x: R_moe._router(p, _f32(ref_reduced(
        arch)), x))(pj, xj)
    if case == "shared":
        assert "shared" in pt
    gg, ig, _ = P_moe._router(pt, cfg, xt)
    np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))
    _check(gg, gw, F32_TOL, "gates")
    if case == "tie":
        assert (ig[..., 0] % 2 == 0).all(), "a tie took the higher expert"
    if case == "over_capacity":
        # a token whose every slot was dropped comes out exactly zero:
        # the same tokens are dropped on both sides
        C = P_moe._capacity(cfg, xt.shape[1])
        dropped_w = np.all(np.asarray(want) == 0, axis=-1)
        dropped_g = np.all(got.numpy() == 0, axis=-1)
        if cfg.moe.top_k == 1:
            assert dropped_w.sum() == 2 * (xt.shape[1] - C) > 0
        np.testing.assert_array_equal(dropped_g, dropped_w)


@pytest.mark.parametrize("impl", ["gather", "einsum"])
def test_moe_bf16_matches_reference(impl):
    """In bf16, on the same bf16 input: the routing is ==, the output
    within two bf16 ulps.  (Across a whole model a one-ulp difference
    upstream can flip a top-k choice, so the full-model bf16 check leaves
    out the two MoE archs; see tests/test_torch_serve.py.)"""
    arch = "moonshot-v1-16b-a3b"
    cfg, (pj, xj, want, _), (pt, xt, got, _) = _moe_case(arch, impl, "random",
                                                         "bfloat16")
    _check(got, want, _bf16_tol(want), f"moe {impl} bf16")


def test_top_k_breaks_ties_as_jax():
    rng = _r(10)
    x = rng.integers(0, 4, (64, 16)).astype(np.float32)   # many ties
    for k in (1, 2, 6):
        vw, iw = jax.lax.top_k(jnp.asarray(x), k)
        vg, ig = P_moe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))
        np.testing.assert_array_equal(vg.numpy(), np.asarray(vw))


# -------------------------------------------------------------------- SSM
def _mlstm_inputs(seed, B=2, S=37, H=2, dh=16):
    rng = _r(seed)
    q, k, v = (_normal(rng, B, S, H, dh) for _ in range(3))
    i_raw, f_raw = _normal(rng, B, S, H), _normal(rng, B, S, H) + 2.0
    state = {"C": _normal(rng, B, H, dh, dh, scale=0.1),
             "n": _normal(rng, B, H, dh, scale=0.1),
             "m": _normal(rng, B, H)}
    return (q, k, v, i_raw, f_raw), state


@pytest.mark.parametrize("state", ["zero", "carried"])
def test_mlstm_sequence_matches_reference(state):
    """S = 37 with chunk 16: the last chunk is padded (NEG_INF input
    gates, decay 1)."""
    xs, st = _mlstm_inputs(11)
    st = None if state == "zero" else st
    want_h, want_s = jax.jit(functools.partial(R_ssm.mlstm_sequence,
                                               chunk=16))(
        *(jnp.asarray(a) for a in xs),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got_h, got_s = P_ssm.mlstm_sequence(
        *(torch.from_numpy(a) for a in xs),
        None if st is None else {k: torch.from_numpy(v) for k, v in st.items()},
        chunk=16)
    _check(got_h, want_h, F32_TOL, "mlstm h")
    for k in ("C", "n", "m"):
        _check(got_s[k], want_s[k], F32_TOL, f"mlstm state {k}")


def test_mlstm_step_matches_reference():
    xs, st = _mlstm_inputs(12, S=1)
    one = [a[:, 0] for a in xs]
    want_h, want_s = jax.jit(R_ssm.mlstm_step)(
        *(jnp.asarray(a) for a in one), {k: jnp.asarray(v)
                                         for k, v in st.items()})
    got_h, got_s = P_ssm.mlstm_step(
        *(torch.from_numpy(a) for a in one), {k: torch.from_numpy(v)
                                              for k, v in st.items()})
    _check(got_h, want_h, F32_TOL, "mlstm step h")
    for k in ("C", "n", "m"):
        _check(got_s[k], want_s[k], F32_TOL, f"mlstm step {k}")


def _block_case(kind, decode, seed):
    arch = "xlstm-125m" if kind in ("mlstm", "slstm") else "hymba-1.5b"
    cfg, rcfg = _f32(reduced_config(arch)), _f32(ref_reduced(arch))
    layout = {"mlstm": P_ssm.mlstm_layout, "slstm": P_ssm.slstm_layout,
              "mamba": P_ssm.mamba_layout}[kind](cfg)
    rng = _r(seed)
    p = _tree(rng, layout)
    pj, pt = _convert(p, layout)
    x = _normal(rng, 2, 1 if decode else 21, cfg.d_model)
    H, dh = cfg.ssm.n_heads, cfg.ssm.head_dim
    if kind == "mlstm":
        st = {"C": _normal(rng, 2, H, dh, dh, scale=0.1),
              "n": _normal(rng, 2, H, dh, scale=0.1), "m": _normal(rng, 2, H)}
    elif kind == "slstm":
        st = {"h": _normal(rng, 2, H, dh, scale=0.5),
              "c": _normal(rng, 2, H, dh, scale=0.5),
              "n": np.abs(_normal(rng, 2, H, dh)) + 0.5,
              "m": _normal(rng, 2, H, dh)}
    else:
        st = {"ssm": _normal(rng, 2, H, dh, cfg.ssm.d_state, scale=0.1),
              "conv": _normal(rng, 2, cfg.ssm.conv_dim - 1, H * dh)}
    fn = {"mlstm": (R_ssm.mlstm_block, P_ssm.mlstm_block),
          "slstm": (R_ssm.slstm_block, P_ssm.slstm_block),
          "mamba": (R_ssm.mamba_block, P_ssm.mamba_block)}[kind]
    want = jax.jit(lambda p, x, s: fn[0](p, rcfg, x, s, decode=decode))(
        pj, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    got = fn[1](pt, cfg, torch.from_numpy(x),
                {k: torch.from_numpy(v) for k, v in st.items()},
                decode=decode)
    return want, got


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_recurrent_blocks_match_reference(kind, decode):
    """Each block from a carried state (the mamba block with its conv
    tail): the output and every state leaf."""
    (want_y, want_s), (got_y, got_s) = _block_case(kind, decode, 13)
    _check(got_y, want_y, F32_TOL, f"{kind} output")
    assert sorted(got_s) == sorted(want_s)
    for k in want_s:
        _check(got_s[k], want_s[k], F32_TOL, f"{kind} state {k}")


def test_ssd_sequence_matches_reference():
    rng = _r(14)
    B, S, H, dh, N = 2, 45, 3, 8, 4
    xh, Bt, Ct = (_normal(rng, B, S, H, dh), _normal(rng, B, S, N),
                  _normal(rng, B, S, N))
    la = -np.abs(_normal(rng, B, S, H, scale=0.3))
    st = _normal(rng, B, H, dh, N, scale=0.1)
    want_y, want_s = jax.jit(functools.partial(R_ssm.ssd_sequence,
                                               chunk=16))(
        *(jnp.asarray(a) for a in (xh, Bt, Ct, la, st)))
    got_y, got_s = P_ssm.ssd_sequence(
        *(torch.from_numpy(a) for a in (xh, Bt, Ct, la, st)), chunk=16)
    _check(got_y, want_y, F32_TOL, "ssd y")
    _check(got_s, want_s, F32_TOL, "ssd state")
