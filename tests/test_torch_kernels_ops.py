"""The port's CiM kernel package against the reference's, on the CPU.

``repro_torch.kernels.ops`` and ``ref`` against ``repro.kernels.ops`` run
in Pallas interpret mode (as ``tests/test_kernels.py`` runs it) and
against ``repro.kernels.ref``, on the same seeded numpy inputs.  On the
CPU each port wrapper takes its kernel's plain version, the oracle of
``repro_torch.kernels.ref`` behind the reference's padding and blocking,
so these tests hold the function that the CUDA kernels reproduce on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Bounds are the
reference tests' own: ``==`` for the integer ops, 2e-5 for f32 attention,
5e-2 for bf16 attention, 2e-3 for mLSTM.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.kernels import mlstm_chunk as ref_mc
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models.attention import flash_attention_jnp

from repro_torch import kernels
from repro_torch.kernels import ops, ref

OPS = ("and", "or", "xor", "add", "sub")
SHAPES = ((8, 128), (100, 300), (17, 1000), (1, 64))


def _r(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------- cim_bitwise
@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", OPS)
def test_cim_bulk_matches_reference(op, shape, dtype):
    r = _r(100 + 10 * OPS.index(op) + SHAPES.index(shape))
    # full 32-bit range: add and sub wrap in both packages
    x = r.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(dtype)
    y = r.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(dtype)
    want = np.asarray(ref_ops.cim_bulk(jnp.asarray(x), jnp.asarray(y), op=op,
                                       interpret=True))
    got = ops.cim_bulk(_t(x), _t(y), op=op)
    assert got.shape == shape and got.numpy().dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.cim_bitwise_ref(_t(x), _t(y), op=op).numpy(),
        np.asarray(ref_ref.cim_bitwise_ref(jnp.asarray(x), jnp.asarray(y),
                                           op=op)))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
def test_cim_fused_composite_matches_reference(dtype):
    r = _r(0)
    x, y, z = (r.integers(0, 2 ** 16, (64, 256)).astype(dtype)
               for _ in range(3))
    want = np.asarray(ref_ops.cim_fused(*map(jnp.asarray, (x, y, z)),
                                        op1="add", op2="xor",
                                        interpret=True))
    got = ops.cim_fused(_t(x), _t(y), _t(z), op1="add", op2="xor")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.cim_bitwise_fused_ref(_t(x), _t(y), _t(z)).numpy(), want)


def test_cim_ops_reject_mismatched_operands():
    x = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="share shape"):
        ops.cim_bulk(x, torch.zeros(4, 9, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 or uint32"):
        ops.cim_bulk(x.float(), x.float())
    with pytest.raises(ValueError, match="unknown op"):
        ops.cim_bulk(x, x, op="nand")


# --------------------------------------------------------- flash_attention
FLASH_SHAPES = ((1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 128, 64))


def _qkv(seed, B, H, Hkv, Sq, d, Skv=None, dtype=np.float32):
    r = _r(seed)
    Skv = Sq if Skv is None else Skv
    return (r.normal(size=(B, H, Sq, d)).astype(dtype),
            r.normal(size=(B, Hkv, Skv, d)).astype(dtype),
            r.normal(size=(B, Hkv, Skv, d)).astype(dtype))


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("window", [0, 32])
def test_flash_attention_matches_reference(shape, window):
    q, k, v = _qkv(200 + FLASH_SHAPES.index(shape) + window, *shape)
    want = np.asarray(ref_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        block_q=64, block_k=64, interpret=True))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, block_q=64, block_k=64)
    _close(got.numpy(), want, 2e-5)
    _close(ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                   window=window).numpy(),
           np.asarray(ref_ref.flash_attention_ref(
               *map(jnp.asarray, (q, k, v)), causal=True, window=window)),
           2e-5)


def test_flash_attention_bf16_matches_reference():
    q, k, v = _qkv(7, 1, 2, 2, 128, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    want = ref_ops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                   block_k=64, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, block_q=64,
                              block_k=64)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), 5e-2)
    _close(ref.flash_attention_ref(tq, tk, tv).float().numpy(),
           np.asarray(ref_ref.flash_attention_ref(jq, jk, jv), np.float32),
           5e-2)


@pytest.mark.parametrize("window", [0, 16])
def test_flash_attention_ragged_causal_quirk(window):
    """ROADMAP Queue 3: with causal masks and Sq > Skv, the rows past Skv
    attend to the zero-padded keys, which neither package masks."""
    q, k, v = _qkv(8, 1, 2, 2, 100, 32, Skv=70)
    want = np.asarray(ref_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        block_q=64, block_k=64, interpret=True))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, block_q=64, block_k=64)
    assert got.shape == (1, 2, 100, 32)
    _close(got.numpy(), want, 2e-5)
    # the quirk itself: a row past Skv is not the attention over real keys
    exact = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                    window=window)
    assert not torch.allclose(got[:, :, 99], exact[:, :, 99], atol=1e-3)


def test_flash_attention_non_causal_ragged_raises():
    q, k, v = _qkv(9, 1, 2, 2, 128, 32, Skv=70)
    with pytest.raises(ValueError, match="non-causal ragged"):
        ref_ops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                block_q=64, block_k=64, interpret=True)
    with pytest.raises(ValueError, match="non-causal ragged"):
        ops.flash_attention(_t(q), _t(k), _t(v), causal=False, block_q=64,
                            block_k=64)


def _flash_bf16_tiles(q, k, v, *, causal, window, split_p=True, block=64):
    """The bf16 CUDA kernel's rounding points in plain torch: Q.K^T in f32
    from bf16 inputs, an online softmax in f32 over ``block``-key tiles,
    P.V in f32 from P split into two bf16 terms, ``hi = bf16(p)`` and
    ``lo = bf16(p - hi)`` (``split_p=False``: from ``hi`` alone), the
    output rounded once.  Every KV tile is visited: a skipped tile is one
    whose scores are all masked for the whole q tile, which the first real
    key clears exactly."""
    G = q.shape[1] // k.shape[1]
    qf = q.float()
    kf, vf = (t.repeat_interleave(G, dim=1).float() for t in (k, v))
    Sq, Skv, d = q.shape[2], k.shape[2], q.shape[3]
    m = torch.full(q.shape[:3], ref.NEG_INF)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(qf.shape)
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block):
        k_pos = torch.arange(k0, min(k0 + block, Skv))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf,
                         kf[:, :, k0:k0 + block]) / math.sqrt(d)
        keep = torch.ones(Sq, k_pos.shape[1], dtype=torch.bool)
        if causal:
            keep = keep & (q_pos >= k_pos)
        if window > 0:
            keep = keep & (q_pos - k_pos < window)
        s = torch.where(keep, s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        p_mma = hi + (p - hi).to(torch.bfloat16).float() if split_p else hi
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p_mma, vf[:, :, k0:k0 + block])
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


def _share_of_card_bound(got, want, tol=(2e-3, 1e-2)):
    """max |got - want| / (atol + rtol |want|): at most 1 within bound."""
    diff = (got.float() - want.float()).abs()
    return float((diff / (tol[0] + tol[1] * want.float().abs())).max())


# seed 2 is the worst of seeds 0-7 for P rounded once (1.32 of the bound)
GEMMA_BF16 = dict(seed=2, B=1, H=4, Hkv=1, Sq=512, d=256)


@pytest.mark.parametrize("window", [0, 128])
def test_flash_attention_bf16_rounding_design_within_card_bound(window):
    """The tensor-core kernel's rounding points keep it within the card's
    bf16 check, atol 2e-3 and rtol 1e-2 against the dense f32 oracle, at
    gemma3-1b's width (H=4, Hkv=1, d=256)."""
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(**GEMMA_BF16))
    got = _flash_bf16_tiles(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=1e-2)
    assert _share_of_card_bound(got, want) < 0.7


def test_flash_attention_bf16_single_p_rounding_misses_card_bound():
    """Why the kernel splits P: rounded once to bf16 for P.V, it can miss
    the card's check (seed 2, causal, d=256), while split it stays under
    0.7 of it."""
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(**GEMMA_BF16))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    once = _flash_bf16_tiles(q, k, v, causal=True, window=0, split_p=False)
    split = _flash_bf16_tiles(q, k, v, causal=True, window=0)
    assert _share_of_card_bound(once, want) > 1.0
    assert _share_of_card_bound(split, want) < 0.7


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: on the int32 view, add
    half of the 13 dropped bits' unit to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """x rounded to TF32 toward zero: the 13 low mantissa bits cleared, as
    the kernel makes its hi part and as the tensor cores read an operand
    that is not TF32 already (its lo part)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


#: how the kernel rounds (``trunc``), and round to nearest for comparison
TF32_ROUNDING = {"trunc": _tf32_trunc, "rna": _tf32}
#: the products of a 3xTF32 split, (A term, B term): A_lo B_hi, A_hi B_lo,
#: A_hi B_hi, summed in that order; A_lo B_lo is dropped
TERMS_3X = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _split_product(eq, a, b, terms, rounding):
    """einsum ``eq`` of f32 ``a`` and ``b`` as the tensor cores run it: each
    operand split into hi = tf32(x) and lo = tf32(x - hi) (``rounding``
    names the TF32 rounding), the products of ``terms`` (each exact in
    f32) summed in f32."""
    tf32 = TF32_ROUNDING[rounding]
    parts = {}
    for name, x in (("a", a), ("b", b)):
        hi = tf32(x)
        parts[name] = dict(hi=hi, lo=tf32(x - hi))
    out = None
    for ta, tb in terms:
        t = torch.einsum(eq, parts["a"][ta], parts["b"][tb])
        out = t if out is None else out + t
    return out


def _flash_f32_tf32_tiles(q, k, v, *, causal, window, split=(TERMS_3X,
                                                           TERMS_3X),
                          rounding="trunc", block=64):
    """The f32 CUDA kernel's rounding points in plain torch: Q.K^T and P.V
    as split TF32 products (``split``: the terms of each, default 3xTF32;
    ``rounding``: the kernel's TF32 rounding toward zero, or ``rna``),
    Q.K^T summed over the two halves of d apart and then added (two warps
    share a row band, one half each), scores times 1/sqrt(d), an online
    softmax in f32 over ``block``-key tiles with exp(x) as 2^(x log2 e),
    the result acc / max(l, 1e-30).  Every KV tile is visited, as in
    ``_flash_bf16_tiles``."""
    qk_terms, pv_terms = split
    G = q.shape[1] // k.shape[1]
    kf, vf = (t.repeat_interleave(G, dim=1) for t in (k, v))
    Sq, Skv, d = q.shape[2], k.shape[2], q.shape[3]
    half = d // 2
    sm_scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    m = torch.full(q.shape[:3], ref.NEG_INF)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block):
        kt, vt = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = (_split_product("bhqd,bhkd->bhqk", q[..., :half],
                            kt[..., :half], qk_terms, rounding)
             + _split_product("bhqd,bhkd->bhqk", q[..., half:],
                              kt[..., half:], qk_terms, rounding)) * sm_scale
        k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        keep = torch.ones(Sq, k_pos.shape[1], dtype=torch.bool)
        if causal:
            keep = keep & (q_pos >= k_pos)
        if window > 0:
            keep = keep & (q_pos - k_pos < window)
        s = torch.where(keep, s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new[..., None]) * LOG2E)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _split_product(
            "bhqk,bhkd->bhqd", p, vt, pv_terms, rounding)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


F32_TOL = (2e-5, 2e-5)              # (atol, rtol): the reference's bound
# gemma3-1b's attention width (H=4, Hkv=1, d=256) on a 512-row prefill
GEMMA_F32 = dict(seed=3, B=1, H=4, Hkv=1, Sq=512, d=256)


def test_tf32_roundings():
    """rna: to nearest, ties away from zero; trunc: toward zero; both to
    10 stored bits, the 13 low bits clear."""
    ulp = 2.0 ** -10                      # TF32's unit at [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -20,
                      -(1.0 + ulp / 2), 1.0 + 1.5 * ulp, 0.0])
    assert torch.equal(_tf32(x), torch.tensor(
        [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp, 0.0]))
    assert torch.equal(_tf32_trunc(x), torch.tensor(
        [1.0, 1.0, 1.0, -1.0, 1.0 + ulp, 0.0]))
    r = torch.from_numpy(_r(4).normal(size=10_000).astype(np.float32))
    for tf32, worst in ((_tf32, 2.0 ** -11), (_tf32_trunc, 2.0 ** -10)):
        t = tf32(r)
        assert torch.equal(t.view(torch.int32) & 0x1FFF,
                           torch.zeros_like(t.view(torch.int32)))
        assert float(((t - r).abs() / r.abs()).max()) <= worst
    # the split: hi + lo is x exactly, lo is under a hi ulp
    hi = _tf32_trunc(r)
    assert torch.equal(hi + (r - hi), r)
    assert bool(((r - hi).abs() < hi.abs() * 2.0 ** -10).all())


@pytest.mark.parametrize("rounding", ["trunc", "rna"])
@pytest.mark.parametrize("window", [0, 128])
def test_flash_attention_f32_rounding_design_within_half_the_bound(
        window, rounding):
    """The tensor-core kernel's 3xTF32 rounding points keep it under half
    of the f32 check, atol 2e-5 and rtol 2e-5 against the dense oracle, at
    gemma3-1b's width, with its TF32 rounding toward zero as with round to
    nearest."""
    q, k, v = (_t(a) for a in _qkv(**GEMMA_F32))
    got = _flash_f32_tf32_tiles(q, k, v, causal=True, window=window,
                                rounding=rounding)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, atol=F32_TOL[0], rtol=F32_TOL[1])
    assert _share_of_card_bound(got, want, F32_TOL) < 0.5


@pytest.mark.parametrize("window", [0, 128])
def test_flash_attention_f32_single_tf32_product_misses_the_bound(window):
    """Why the kernel splits: one TF32 product per product (10 bits of
    each operand) misses the f32 check many times over."""
    q, k, v = (_t(a) for a in _qkv(**GEMMA_F32))
    single = ((("hi", "hi"),),) * 2
    got = _flash_f32_tf32_tiles(q, k, v, causal=True, window=window,
                                split=single)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert _share_of_card_bound(got, want, F32_TOL) > 2.0


@pytest.mark.parametrize("dropped", [("lo", "hi"), ("hi", "lo")])
def test_flash_attention_f32_pv_needs_all_three_terms(dropped):
    """P.V keeps all three products: without P_lo V_hi (P's rounding) or
    P_hi V_lo (V's) the result misses the f32 check (many times over at
    this seed), with Q.K^T in 3xTF32 as the kernel runs it."""
    q, k, v = (_t(a) for a in _qkv(**GEMMA_F32))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    two = tuple(t for t in TERMS_3X if t != dropped)
    got = _flash_f32_tf32_tiles(q, k, v, causal=True, window=0,
                                split=(TERMS_3X, two))
    assert _share_of_card_bound(got, want, F32_TOL) > 1.0


@pytest.mark.parametrize("window", [0, 32])
def test_flash_attention_f32_rounding_design_matches_reference_kernel(window):
    """The emulated kernel against the reference's Pallas kernel (interpret
    mode) on a small GQA shape with a ragged last KV tile."""
    q, k, v = _qkv(12, 1, 4, 2, 96, 64)
    want = np.asarray(ref_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        block_q=32, block_k=32, interpret=True))
    got = _flash_f32_tf32_tiles(_t(q), _t(k), _t(v), causal=True,
                                window=window)
    _close(got.numpy(), want, 2e-5)


def test_flash_attention_matches_model_path():
    """Port kernel path vs the reference model stack's chunked-jnp flash."""
    r = _r(9)
    B, H, S, d = 1, 2, 128, 32
    q, k, v = (r.normal(size=(B, S, H, d)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(flash_attention_jnp(*map(jnp.asarray, (q, k, v)),
                                          causal=True, block=64))
    got = ops.flash_attention(*(_t(a).transpose(1, 2) for a in (q, k, v)),
                              causal=True, block_q=64,
                              block_k=64).transpose(1, 2)
    _close(got.numpy(), want, 2e-5)


# ------------------------------------------------------------- mlstm_chunk
MLSTM_SHAPES = ((1, 1, 64, 16, 16), (2, 2, 128, 32, 32), (1, 2, 128, 64, 64))


def _mlstm_in(seed, B, H, S, dh):
    r = _r(seed)
    q, k, v = (r.normal(size=(B, H, S, dh)).astype(np.float32)
               for _ in range(3))
    ir = r.normal(size=(B, H, S)).astype(np.float32)
    fr = (r.normal(size=(B, H, S)) + 3.0).astype(np.float32)
    return q, k, v, ir, fr


@pytest.mark.parametrize("shape", MLSTM_SHAPES)
def test_mlstm_chunkwise_matches_reference(shape):
    *dims, chunk = shape
    a = _mlstm_in(300 + MLSTM_SHAPES.index(shape), *dims)
    want = np.asarray(ref_ops.mlstm_chunkwise(*map(jnp.asarray, a),
                                              chunk=chunk, interpret=True))
    got = ops.mlstm_chunkwise(*map(_t, a), chunk=chunk)
    _close(got.numpy(), want, 2e-3)
    _close(ref.mlstm_chunkwise_ref(*map(_t, a)).numpy(),
           np.asarray(ref_ref.mlstm_chunkwise_ref(*map(jnp.asarray, a))),
           2e-3)


def test_mlstm_chunk_invariance():
    """The reference's chunk 16 and chunk 64 both give the port's result
    (the port's kernel is held across chunks on the card)."""
    a = _mlstm_in(11, 1, 1, 64, 16)
    for chunk in (16, 64):
        want = np.asarray(ref_ops.mlstm_chunkwise(
            *map(jnp.asarray, a), chunk=chunk, interpret=True))
        got = ops.mlstm_chunkwise(*map(_t, a), chunk=chunk)
        _close(got.numpy(), want, 2e-3)


def test_mlstm_ragged_chunk_halves_like_reference():
    a = _mlstm_in(12, 1, 2, 48, 16)              # chunk 32 -> 16
    want = np.asarray(ref_ops.mlstm_chunkwise(*map(jnp.asarray, a),
                                              chunk=32, interpret=True))
    _close(ops.mlstm_chunkwise(*map(_t, a), chunk=32).numpy(), want, 2e-3)


def test_plain_versions_launch_nothing():
    kernels.reset_launch_counts()
    x = torch.zeros(8, 128, dtype=torch.int32)
    ops.cim_bulk(x, x)
    ops.cim_fused(x, x, x)
    assert set(kernels.launch_counts()) == set(kernels.KERNELS)
    assert all(n == 0 for n in kernels.launch_counts().values())


def _mlstm_chunk_parallel(q, k, v, i_raw, f_raw, chunk):
    """The CUDA kernel's decomposition in torch f32: (0) the gates and the
    stabilizer chain over the chunks in order; (1) each chunk's own state
    update, dC = sum_j e^(g_j - max g) k_j v_j^T and dn, all chunks at
    once; (2) a scan of the state, C_k = w_prev C_{k-1} + e^(F + max g -
    m_k) dC_k, keeping each chunk's start state; (3) every chunk's
    outputs at once from its start state, with the inter-chunk weight
    folded into q."""
    B, H, S, dh = q.shape
    K = min(chunk, S)
    while S % K:
        K //= 2
    nc, scale = S // K, 1.0 / math.sqrt(dh)
    li, lf = (x.reshape(B, H, nc, K) for x in ref.log_gates(i_raw, f_raw))
    qf, kf, vf = (x.float().reshape(B, H, nc, K, dh) for x in (q, k, v))
    # (0) gates: b = cumsum(lf) in order, the chain of m over the chunks
    b = torch.cumsum(lf, -1)
    g = li - b
    F, gmax = b[..., -1], g.amax(-1)
    m = torch.full((B, H), ref.NEG_INF)
    m_prev, w_prev, upd = [], [], []
    for c in range(nc):
        m_next = torch.maximum(m + F[..., c], F[..., c] + gmax[..., c])
        m_prev.append(m)
        w_prev.append(torch.exp(m + F[..., c] - m_next))
        upd.append(torch.exp(F[..., c] + gmax[..., c] - m_next))
        m = m_next
    m_prev = torch.stack(m_prev, -1)[..., None]           # (B, H, nc, 1)
    m_t = torch.maximum(torch.cummax(g, -1).values + b, m_prev + b)
    inter = torch.exp((m_prev + b) - m_t)
    # (1) each chunk's update, from its own keys and values
    kw = kf * torch.exp(g - gmax[..., None])[..., None]
    dC = torch.einsum("bhcja,bhcje->bhcae", kw, vf)
    dn = kw.sum(-2)
    # (2) the scan: the state at each chunk's start
    C, n = torch.zeros(B, H, dh, dh), torch.zeros(B, H, dh)
    C0, n0 = [], []
    for c in range(nc):
        C0.append(C)
        n0.append(n)
        a, s = w_prev[c][..., None], upd[c][..., None]
        C, n = a[..., None] * C + s[..., None] * dC[:, :, c], \
            a * n + s * dn[:, :, c]
    C0, n0 = torch.stack(C0, 2), torch.stack(n0, 2)
    # (3) outputs
    D = torch.exp(b[..., :, None] + g[..., None, :] - m_t[..., :, None])
    D = torch.where(torch.ones(K, K, dtype=torch.bool).tril(), D, 0.0)
    w = (torch.einsum("bhcta,bhcja->bhctj", qf, kf) * scale) * D
    qi = qf * (inter * scale)[..., None]
    num = w @ vf + qi @ C0
    den = w.sum(-1) + (qi * n0[..., None, :]).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    return h.reshape(B, H, S, dh).to(q.dtype)


# (B, H, S, dh, chunk): 1, 2 and 16 chunks, and a ragged S whose chunk
# halves (48 by 32 -> 16)
MLSTM_SPLIT_SHAPES = ((1, 2, 64, 16, 64), (2, 2, 128, 32, 64),
                      (1, 1, 256, 16, 16), (1, 2, 48, 16, 32))


@pytest.mark.parametrize("shape", MLSTM_SPLIT_SHAPES)
def test_mlstm_chunk_parallel_decomposition_matches_reference(shape):
    """The kernel's split across chunks -- per-chunk updates, a scan of the
    state, per-chunk outputs -- holds to the reference's Pallas kernel
    (interpret mode) and to the token-by-token oracle at 2e-3."""
    *dims, chunk = shape
    a = _mlstm_in(400 + MLSTM_SPLIT_SHAPES.index(shape), *dims)
    got = _mlstm_chunk_parallel(*map(_t, a), chunk=chunk)
    K = min(chunk, dims[2])
    while dims[2] % K:                       # as the wrappers halve it
        K //= 2
    want = np.asarray(ref_mc.mlstm_chunkwise(*map(jnp.asarray, a),
                                             chunk=K, interpret=True))
    _close(got.numpy(), want, 2e-3)
    _close(got.numpy(), ref.mlstm_chunkwise_ref(*map(_t, a)).numpy(), 2e-3)
    _close(got.numpy(), np.asarray(ref_ref.mlstm_chunkwise_ref(
        *map(jnp.asarray, a))), 2e-3)
