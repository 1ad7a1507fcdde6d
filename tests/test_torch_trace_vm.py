"""The port's trace VM against the reference's: the same program, written
in JAX and in torch, run on the same numpy inputs, must commit the same
instruction columns (every array of ``ColumnarTrace.to_arrays()`` ``==``)
and compute the same outputs.  Twins of ``tests/test_trace_vm.py``, one
case per ATen op the dispatch mode handles, the loop helpers, and the
machine driven directly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trace as rtrace
from repro.core.isa import SRC_IMM, SRC_REG
from repro_torch.core import trace as ptrace
from repro_torch.core.trace import (TraceLimits, cond, scan,
                                    trace_program, trace_structural,
                                    while_loop)
from repro_torch.workloads.lowering import (F32, I32, astype, dynamic_slice,
                                            imm, remainder, take, update_at,
                                            wrap)


def same_trace(jax_fn, torch_fn, *arrays, product=False):
    """Trace ``jax_fn`` with the reference VM and ``torch_fn`` with the
    port's on the same numpy ``arrays``; assert equal columns and outputs,
    and the port's outputs equal to eager ``torch_fn``.  A float product's
    values come from XLA in the reference and from torch in the port, so
    with ``product`` its outputs may differ in the last bit (they are never
    immediates, so the columns stay equal)."""
    arrays = [np.asarray(a) for a in arrays]
    ref = rtrace.trace_structural(jax_fn, *[jnp.asarray(a) for a in arrays])
    targs = [torch.from_numpy(a.copy()) for a in arrays]
    got = trace_structural(torch_fn, *targs, device="cpu")
    want, have = ref.columns.to_arrays(), got.columns.to_arrays()
    assert sorted(want) == sorted(have)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert len(got.outputs) == len(ref.outputs)
    eager = torch.utils._pytree.tree_leaves(
        torch_fn(*[torch.from_numpy(a.copy()) for a in arrays]))
    for g, w, e in zip(got.outputs, ref.outputs, eager):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        if product:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_allclose(g.numpy(), e.numpy().astype(w.dtype),
                                   rtol=1e-5, atol=1e-5)
    return got


# ------------------------------------------------- twins of test_trace_vm
def test_elementwise_chain():
    a = np.arange(16, dtype=np.float32)
    b = np.ones(16, np.float32) * 2
    got = same_trace(lambda a, b: jnp.sum((a + b) * a - b),
                     lambda a, b: torch.sum((a + b) * a - b), a, b)
    assert got.n_instructions > 0


def test_matmul_reduction_argmax():
    A = np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)
    B = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)

    def f(A, B):
        C = A @ B
        return jnp.max(C), jnp.argmax(C, axis=1), jnp.sum(C, axis=0)

    def g(A, B):
        C = A @ B
        return torch.max(C), torch.argmax(C, 1), torch.sum(C, 0)
    same_trace(f, g, A, B)


def test_control_flow_scan_while_cond():
    def f(x):
        def body(c, t):
            c = jax.lax.cond(t % 2 == 0, lambda c: c + x[t],
                             lambda c: c * 0.5, c)
            return c, c
        c, ys = jax.lax.scan(body, 0.0, jnp.arange(6))

        def wcond(s):
            return s[0] < 3

        def wbody(s):
            return (s[0] + 1, s[1] + c)
        _, acc = jax.lax.while_loop(wcond, wbody, (jnp.int32(0), 0.0))
        return acc, ys

    def g(x):
        def hit(c, t):
            xt = take(x, t)
            return astype(c, F32) + xt

        def body(c, t):
            c = cond(remainder(t, 2) == 0, hit, lambda c, t: c * 0.5, c, t)
            return c, c
        c, ys = scan(body, imm(0.0, F32), torch.arange(6, dtype=I32))
        _, acc = while_loop(lambda s: s[0] < 3,
                            lambda s: (s[0] + 1, s[1] + c),
                            (imm(0), imm(0.0, F32)))
        return acc, ys
    same_trace(f, g, np.arange(6, dtype=np.float32))


def test_gather_scatter_dynamic():
    def f(x, idx, v, s):
        y = x[idx]                              # gather
        z = x.at[idx].add(v)                    # scatter-add
        w = jax.lax.dynamic_slice(z, (s,), (4,))
        return jnp.sum(y) + jnp.sum(w)

    def g(x, idx, v, s):
        y = x[wrap(idx, 12)]
        z = x.index_put((wrap(idx, 12),), v, accumulate=True)
        w = dynamic_slice(z, s, 4)
        return torch.sum(y) + torch.sum(w)
    same_trace(f, g, np.arange(12, dtype=np.float32),
               np.asarray([1, 5, 7], np.int32), np.ones(3, np.float32),
               np.int32(2))


def test_concat_pad_sort_select():
    def f(a, b):
        c = jnp.concatenate([a, b * 2])
        d = jnp.pad(c, (1, 1), constant_values=-1.0)
        e = jnp.sort(d)
        return jnp.where(e > 0, e, -e)

    def g(a, b):
        c = torch.cat([a, b * 2])
        d = torch.nn.functional.pad(c, (1, 1), value=-1.0)
        e = torch.sort(d).values
        return torch.where(e > 0, e, -e)
    same_trace(f, g, np.asarray([3.0, -1.0, 2.0], np.float32),
               np.asarray([0.5, -4.0], np.float32))


def test_pattern_variants_present():
    """The Fig. 4 variants must all arise: (a) load-load-op, (b) imm
    operand, (c) register-forwarded operand."""
    a = np.arange(32, dtype=np.int32)
    same_trace(lambda a, b: jnp.sum((a + b) ^ 3),
               lambda a, b: torch.sum((a + b) ^ 3), a, a)
    tr = trace_program(lambda a, b: torch.sum((a + b) ^ 3),
                       torch.from_numpy(a), torch.from_numpy(a), device="cpu")
    kinds = set()
    for inst in tr.trace:
        if inst.op in ("add", "xor"):
            tags = tuple(t for t, _ in inst.srcs)
            if tags == (SRC_REG, SRC_REG):
                kinds.add("reg_reg")
            if SRC_IMM in tags:
                kinds.add("imm")
    assert "reg_reg" in kinds and "imm" in kinds


def test_rut_iht_consistency():
    a = np.arange(8, dtype=np.float32)
    same_trace(lambda a: jnp.sum(a * 2.0), lambda a: torch.sum(a * 2.0), a)
    tr = trace_program(lambda a: torch.sum(a * 2.0), torch.from_numpy(a),
                       device="cpu")
    for seq, entries in tr.iht.items():
        inst = tr.trace[seq]
        regs = [v for t, v in inst.srcs if t == SRC_REG]
        assert len(entries) == len(regs)
        for (r, pos), r2 in zip(entries, regs):
            assert r == r2
            writes = tr.rut[r]
            if 0 <= pos < len(writes):
                assert writes[pos] < seq or tr.trace[writes[pos]].dst == inst.dst
    n_regs = max(tr.rut) + 1
    for inst in tr.trace:
        if inst.dst is not None:
            assert 0 <= inst.dst < n_regs


def test_loop_buffer_reuse_bounds_footprint():
    """Scan temporaries must recycle addresses (compiled-loop realism)."""
    def f(x):
        def body(c, t):
            y = x * t + c
            return jnp.sum(y) * 1e-3, jnp.max(y)
        return jax.lax.scan(body, 0.0, jnp.arange(64, dtype=jnp.float32))

    def g(x):
        def body(c, t):
            y = x * t + astype(c, F32)
            return torch.sum(y) * 1e-3, torch.max(y)
        return scan(body, imm(0.0, F32), torch.arange(64, dtype=F32))
    got = same_trace(f, g, np.arange(64, dtype=np.float32))
    ct = got.columns
    addrs = set(ct.addr[ct.mem_mask].tolist())
    assert len(addrs) < 64 * 64


@pytest.mark.parametrize("n,opname", [(2, "add"), (7, "mul"), (13, "max"),
                                      (24, "add"), (5, "max")])
def test_property_elementwise_matches_numpy(n, opname):
    r = np.random.default_rng(n)
    a = r.normal(size=(n,)).astype(np.float32)
    b = r.normal(size=(n,)).astype(np.float32)
    jop = {"add": jnp.add, "mul": jnp.multiply, "max": jnp.maximum}[opname]
    top = {"add": torch.add, "mul": torch.mul, "max": torch.maximum}[opname]
    got = same_trace(lambda a, b: jop(a, b), lambda a, b: top(a, b), a, b)
    assert int((got.columns.op == ptrace.OP_STORE).sum()) == n


# ---------------------------------------------------- one case per ATen op
_R = np.random.default_rng(7)
FX = _R.normal(size=(6,)).astype(np.float32)
FY = _R.normal(size=(6,)).astype(np.float32)
FP = (np.abs(FX) + 0.5).astype(np.float32)                 # positive
IX = _R.integers(-20, 20, (6,)).astype(np.int32)
IY = _R.integers(1, 7, (6,)).astype(np.int32)              # positive
M34 = _R.normal(size=(3, 4)).astype(np.float32)
M45 = _R.normal(size=(4, 5)).astype(np.float32)
B234 = _R.normal(size=(2, 3, 4)).astype(np.float32)
B245 = _R.normal(size=(2, 4, 5)).astype(np.float32)
IDX = np.asarray([4, 0, 2], np.int32)

OP_CASES = {
    # binary elementwise
    "add": (lambda x, y: x + y, lambda x, y: x + y, FX, FY),
    "sub": (lambda x, y: x - y, lambda x, y: x - y, FX, FY),
    "mul": (lambda x, y: x * y, lambda x, y: x * y, FX, FY),
    "div": (lambda x, y: x / y, lambda x, y: x / y, FX, FP),
    "div_trunc": (lambda x, y: jax.lax.div(x, y),
                  lambda x, y: torch.div(x, y, rounding_mode="trunc"),
                  np.abs(IX), IY),
    "maximum": (jnp.maximum, torch.maximum, FX, FY),
    "minimum": (jnp.minimum, torch.minimum, FX, FY),
    "bitwise_and": (jnp.bitwise_and, torch.bitwise_and, IX, IY),
    "bitwise_or": (jnp.bitwise_or, torch.bitwise_or, IX, IY),
    "bitwise_xor": (jnp.bitwise_xor, torch.bitwise_xor, IX, IY),
    "logical_and": (lambda x, y: jnp.logical_and(x > 0, y > 0),
                    lambda x, y: torch.logical_and(x > 0, y > 0), FX, FY),
    "logical_or": (lambda x, y: jnp.logical_or(x > 0, y > 0),
                   lambda x, y: torch.logical_or(x > 0, y > 0), FX, FY),
    "logical_xor": (lambda x, y: jnp.logical_xor(x > 0, y > 0),
                    lambda x, y: torch.logical_xor(x > 0, y > 0), FX, FY),
    "fmod": (lambda x, y: jax.lax.rem(x, y), torch.fmod, np.abs(IX), IY),
    "remainder": (lambda x, y: jax.lax.rem(x, y), torch.remainder,
                  np.abs(IX), IY),
    "pow": (jnp.power, torch.pow, FP, FY),
    "pow_scalar": (lambda x: x ** 0.5, lambda x: x ** 0.5, FP),
    "integer_pow": (lambda x: x ** 3, lambda x: x ** 3, FX),
    "square": (jnp.square, torch.square, FX),
    "shift_left": (lambda x, y: jnp.left_shift(x, y),
                   torch.bitwise_left_shift, np.abs(IX), IY),
    "shift_right": (lambda x, y: jnp.right_shift(x, y),
                    torch.bitwise_right_shift, np.abs(IX), IY),
    "lt": (lambda x, y: x < y, lambda x, y: x < y, FX, FY),
    "le": (lambda x, y: x <= y, lambda x, y: x <= y, FX, FY),
    "gt": (lambda x, y: x > y, lambda x, y: x > y, FX, FY),
    "ge": (lambda x, y: x >= y, lambda x, y: x >= y, FX, FY),
    "eq": (lambda x, y: x == y, lambda x, y: x == y, IX, IY),
    "ne": (lambda x, y: x != y, lambda x, y: x != y, IX, IY),
    "scalar_operand": (lambda x: x * 3 + 1.5, lambda x: x * 3 + 1.5, FX),
    "rsub": (lambda x: 1 - x, lambda x: 1 - x, IX),
    "left_literal": (lambda x: 2 * x, lambda x: imm(2) * x, IX),
    "broadcast": (lambda m, v: m + v[None, :], lambda m, v: m + v,
                  M34, FX[:4]),
    # unary elementwise
    "bitwise_not": (lambda x: jnp.bitwise_not(x > 0),
                    lambda x: torch.bitwise_not(x > 0), IX),
    "logical_not": (lambda x: jnp.logical_not(x > 0),
                    lambda x: torch.logical_not(x > 0), FX),
    "neg": (lambda x: -x, lambda x: -x, FX),
    "abs": (jnp.abs, torch.abs, IX),
    "sign": (jnp.sign, torch.sign, FX),
    "exp": (jnp.exp, torch.exp, FX),
    "log": (jnp.log, torch.log, FP),
    "tanh": (jnp.tanh, torch.tanh, FX),
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid, FX),
    "sqrt": (jnp.sqrt, torch.sqrt, FP),
    "rsqrt": (jax.lax.rsqrt, torch.rsqrt, FP),
    "floor": (jnp.floor, torch.floor, FX),
    "ceil": (jnp.ceil, torch.ceil, FX),
    "round": (jnp.round, torch.round, FX * 3),
    "exp2": (jnp.exp2, torch.exp2, FX),
    "log1p": (jnp.log1p, torch.log1p, FP),
    "expm1": (jnp.expm1, torch.expm1, FX),
    "cos": (jnp.cos, torch.cos, FX),
    "sin": (jnp.sin, torch.sin, FX),
    "tan": (jnp.tan, torch.tan, FX),
    # conversions, selects
    "_to_copy": (lambda x: x.astype(jnp.int32), lambda x: x.to(I32), FX * 4),
    "where": (lambda x, y: jnp.where(x > y, x, y),
              lambda x, y: torch.where(x > y, x, y), FX, FY),
    "where_literals": (lambda x: jnp.where(x > 0, 0, 1),
                       lambda x: torch.where(x > 0, 0, 1), FX),
    "clamp": (lambda x: jax.lax.clamp(np.float32(-0.5), x, np.float32(0.5)),
              lambda x: torch.clamp(x, -0.5, 0.5), FX),
    "cumsum": (lambda x: jnp.cumsum(x), lambda x: torch.cumsum(x, 0), IX),
    # reductions
    "sum": (lambda m: jnp.sum(m, axis=1), lambda m: torch.sum(m, 1), M34),
    "sum_all": (jnp.sum, torch.sum, M34),
    "sum_keepdim": (lambda m: jnp.sum(m, axis=0, keepdims=True),
                    lambda m: torch.sum(m, 0, keepdim=True), M34),
    "prod": (lambda m: jnp.prod(m, axis=0), lambda m: torch.prod(m, 0), M34),
    "amax": (lambda m: jnp.max(m, axis=0), lambda m: torch.amax(m, 0), M34),
    "amin": (lambda m: jnp.min(m, axis=1), lambda m: torch.amin(m, 1), M34),
    "max": (jnp.max, torch.max, M34),
    "min": (jnp.min, torch.min, M34),
    "argmax": (lambda m: jnp.argmax(m, axis=1),
               lambda m: torch.argmax(m, 1), M34),
    "argmin": (jnp.argmin, torch.argmin, FX),
    # products
    "mm": (lambda a, b: a @ b, torch.mm, M34, M45),
    "mv": (lambda a, b: a @ b, torch.mv, M34, FX[:4]),
    "dot": (jnp.dot, torch.dot, FX, FY),
    "bmm": (jax.lax.batch_matmul, torch.bmm, B234, B245),
    # views: no instructions, the consumer reads through them
    "view": (lambda m: m.reshape(4, 3) + 1, lambda m: m.view(4, 3) + 1, M34),
    "_unsafe_view": (lambda m: m.T.reshape(12) + 1,
                     lambda m: m.t().reshape(12) + 1, M34),
    "squeeze": (lambda m: jnp.squeeze(m[None], 0) + 1,
                lambda m: m[None].squeeze(0) + 1, M34),
    "unsqueeze": (lambda v: v[:, None] * v[None, :],
                  lambda v: v[:, None] * v[None, :], FX),
    "expand": (lambda v: jnp.broadcast_to(v, (3, 6)) + 1,
               lambda v: v.expand(3, 6) + 1, FX),
    "select": (lambda m: m[2] + 1, lambda m: m[2] + 1, M34),
    "slice": (lambda v: jax.lax.slice(v, (1,), (5,), (2,)) + 1,
              lambda v: v[1:5:2] + 1, FX),
    "permute": (lambda b: jnp.transpose(b, (2, 0, 1)) + 1,
                lambda b: b.permute(2, 0, 1) + 1, B234),
    "t": (lambda m: m.T + 1, lambda m: m.t() + 1, M34),
    "transpose": (lambda b: jnp.swapaxes(b, 0, 2) + 1,
                  lambda b: b.transpose(0, 2) + 1, B234),
    "flip": (lambda v: jnp.flip(v) + 1, lambda v: torch.flip(v, (0,)) + 1,
             FX),
    "unfold": (lambda v, i: jax.vmap(
        lambda k: jax.lax.dynamic_slice(v, (k,), (3,)))(i),
        lambda v, i: v.unfold(0, 3, 1)[wrap(i, 6)], FX, IDX[1:] + 1),
    "clone": (lambda v: jnp.copy(v) + 1, lambda v: v.clone() + 1, FX),
    "detach": (lambda v: jax.lax.stop_gradient(v) + 1,
               lambda v: v.detach() + 1, FX),
    "alias": (lambda v: v[...] + 1, lambda v: v[...] + 1, FX),
    "lift_fresh": (lambda v: v + jnp.asarray(1.5, jnp.float32),
                   lambda v: v + torch.tensor(1.5), FX),
    # literals and iota: immediates
    "full": (lambda v: v + jnp.full((6,), 2.5, jnp.float32),
             lambda v: v + torch.full((6,), 2.5), FX),
    "zeros": (lambda v: v * jnp.zeros(6), lambda v: v * torch.zeros(6), FX),
    "ones": (lambda v: v * jnp.ones(6), lambda v: v * torch.ones(6), FX),
    "full_like": (lambda v: v + jnp.full_like(v, 3.0),
                  lambda v: v + torch.full_like(v, 3.0), FX),
    "zeros_like": (lambda v: v - jnp.zeros_like(v),
                   lambda v: v - torch.zeros_like(v), FX),
    "ones_like": (lambda v: v * jnp.ones_like(v),
                  lambda v: v * torch.ones_like(v), FX),
    "new_full": (lambda v: v + jnp.full((6,), 4.0, jnp.float32),
                 lambda v: v + v.new_full((6,), 4.0), FX),
    "new_zeros": (lambda v: v + jnp.zeros((6,), jnp.float32),
                  lambda v: v + v.new_zeros(6), FX),
    "new_ones": (lambda v: v + jnp.ones((6,), jnp.float32),
                 lambda v: v + v.new_ones(6), FX),
    "scalar_tensor": (lambda v: jnp.where(v > 0, 0.0, 1.0),
                      lambda v: torch.where(v > 0, 0.0, 1.0), FX),
    "arange": (lambda v: v + jnp.arange(6, dtype=jnp.int32),
               lambda v: v + torch.arange(6, dtype=I32), IX),
    # data movement
    "cat": (lambda x, y: jnp.concatenate([x, y[:2]]) * 2,
            lambda x, y: torch.cat([x, y[:2]]) * 2, FX, FY),
    "constant_pad_nd": (lambda v: jnp.pad(v, (2, 1)) + 1,
                        lambda v: torch.nn.functional.pad(v, (2, 1)) + 1, FX),
    "index": (lambda v, i: v[i] * 2, lambda v, i: v[wrap(i, 6)] * 2, FX, IDX),
    "index_put": (lambda v, i: v.at[i].set(7.0),
                  lambda v, i: v.index_put((wrap(i, 6),), imm(7.0, F32)),
                  FX, IDX),
    "index_put_accumulate": (
        lambda v, i, u: v.at[i].add(u),
        lambda v, i, u: v.index_put((wrap(i, 6),), u, accumulate=True),
        FX, IDX, FY[:3]),
    "slice_scatter": (lambda v, u, k: jax.lax.dynamic_update_slice(v, u, (k,)),
                      lambda v, u, k: update_at(v, u, k),
                      FX, FY[:2], np.int32(3)),
    "sort": (lambda v: jnp.sort(v) + 1, lambda v: torch.sort(v).values + 1,
             FX),
    # reads of a value: no instructions
    "_local_scalar_dense": (lambda v, k: v[k] * 2,
                            lambda v, k: take(v, k) * 2, FX, np.int32(4)),
    "is_nonzero": (lambda v, k: (k > 0, v * 2)[1],
                   lambda v, k: v * 2 if bool(k > 0) else v, FX, np.int32(1)),
}


PRODUCTS = ("mm", "mv", "dot", "bmm")


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_aten_op_matches_reference(case):
    jax_fn, torch_fn, *arrays = OP_CASES[case]
    same_trace(jax_fn, torch_fn, *arrays, product=case in PRODUCTS)


def test_closed_over_constants_are_stored_after_the_inputs():
    w = np.arange(5, dtype=np.float32) - 2
    s = np.float32(3.0)

    def f(x):
        return x * jnp.asarray(w) + jnp.asarray(s)

    tw, ts = torch.from_numpy(w.copy()), torch.tensor(s)

    def g(x):
        return x * tw + ts
    g.consts = (tw, ts)                   # a 0-d constant is an immediate
    got = same_trace(f, g, FX[:5])
    assert int(got.columns.addr.max()) >= 0x1000 + 64 + 4 * 4


@pytest.mark.parametrize("draw", ["randint", "rand"])
def test_random_draw_is_a_zero_immediate_like_the_reference(draw):
    """A random draw followed by arithmetic: the reference prices
    ``random_seed``/``_unwrap``/``_wrap``/``_bits`` as a zero-data value
    that emits nothing, and the port its ATen draws (``randint`` /
    ``rand`` with an explicit generator) the same way, so the columns and
    outputs are ``==`` (the VM computes on zeros where the program drew)."""
    if draw == "randint":
        x = np.arange(8, dtype=np.int32) - 3

        def jax_fn(v):
            bits = jax.random.bits(jax.random.PRNGKey(3), v.shape, jnp.uint32)
            return v * 2 + bits.astype(jnp.int32)

        def torch_fn(v):
            g = torch.Generator().manual_seed(3)
            return v * 2 + torch.randint(-2 ** 31, 2 ** 31, v.shape,
                                         dtype=torch.int32, generator=g)
    else:
        x = FX

        def jax_fn(v):
            bits = jax.random.bits(jax.random.PRNGKey(3), v.shape, jnp.uint32)
            return v * 2 + bits.astype(jnp.float32)

        def torch_fn(v):
            g = torch.Generator().manual_seed(3)
            return v * 2 + torch.rand(v.shape, generator=g)
    ref = rtrace.trace_structural(jax_fn, jnp.asarray(x))
    got = trace_structural(torch_fn, torch.from_numpy(x.copy()), device="cpu")
    want, have = ref.columns.to_arrays(), got.columns.to_arrays()
    assert sorted(want) == sorted(have)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert got.n_instructions == ref.n_instructions > 0
    np.testing.assert_array_equal(got.outputs[0].numpy(),
                                  np.asarray(ref.outputs[0]))
    np.testing.assert_array_equal(got.outputs[0].numpy(), x * 2)


# ---------------------------------------------------------- control flow
def test_scan_matches_reference():
    def f(x, xs):
        return jax.lax.scan(lambda c, t: (c * t + x, c - t), x, xs)

    def g(x, xs):
        return scan(lambda c, t: (c * t + x, c - t), x, xs)
    same_trace(f, g, FX[:3], np.ascontiguousarray(M34.T))


def test_scan_reversed_matches_reference():
    def f(x, xs):
        return jax.lax.scan(lambda c, t: (c + t, c * t), x, xs, reverse=True)

    def g(x, xs):
        return scan(lambda c, t: (c + t, c * t), x, xs, reverse=True)
    same_trace(f, g, FX[:4], M34)


def test_scan_without_inputs_matches_reference():
    def f(x):
        return jax.lax.scan(lambda c, _: (c * 2, None), x, None, length=5)[0]

    def g(x):
        return scan(lambda c, _: (c * 2, None), x, None, length=5)[0]
    same_trace(f, g, IX)


def test_while_loop_matches_reference():
    def f(x, n):
        return jax.lax.while_loop(lambda s: s[0] < n,
                                  lambda s: (s[0] + 1, s[1] * 2 - 1),
                                  (jnp.int32(0), x))[1]

    def g(x, n):
        return while_loop(lambda s: s[0] < n,
                          lambda s: (s[0] + 1, s[1] * 2 - 1),
                          (imm(0), x))[1]
    same_trace(f, g, IX, np.int32(4))


@pytest.mark.parametrize("k", [0, 5])
def test_cond_matches_reference(k):
    def f(x, k):
        return jax.lax.cond(k > 2, lambda v: v * 2, lambda v: v - 1, x)

    def g(x, k):
        return cond(k > 2, lambda v: v * 2, lambda v: v - 1, x)
    same_trace(f, g, FX, np.int32(k))


def test_reentered_inner_loop_reuses_its_slots():
    """An inner loop re-entered from each outer step keeps one scope (the
    reference keys it by its body jaxpr, the port by its body's code)."""
    def f(x, xs):
        def outer(c, row):
            c2, ys = jax.lax.scan(lambda a, t: (a + t * c[0], a * t), c, row)
            return c2 + 1, ys
        return jax.lax.scan(outer, x, xs)

    def g(x, xs):
        def outer(c, row):
            c2, ys = scan(lambda a, t: (a + t * c[0], a * t), c, row)
            return c2 + 1, ys
        return scan(outer, x, xs)
    got = same_trace(f, g, FX[:2], M34)
    ct = got.columns
    # six outer steps of four inner steps would need 3 x 4 x ... fresh
    # slots without reuse; the shared scope keeps the footprint small
    assert len(set(ct.addr[ct.mem_mask].tolist())) < 100


def test_loops_run_eagerly_outside_the_vm():
    xs = torch.arange(5, dtype=I32)
    c, ys = scan(lambda c, t: (c + t, c * t), imm(1), xs)
    assert int(c) == 11 and ys.tolist() == [0, 1, 4, 12, 28]
    c, ys = scan(lambda c, t: (c + t, c), imm(0), xs, reverse=True)
    assert ys.tolist() == [10, 9, 7, 4, 0]
    assert while_loop(lambda s: s < 10, lambda s: s * 3, imm(1)).item() == 27
    assert cond(imm(1) > 0, lambda v: v + 1, lambda v: v - 1, imm(5)) == 6


# ------------------------------------------------------------- machine
def _drive(mod):
    """One call sequence on either package's Machine: arena allocation
    in and out of loop scopes (reuse across iterations and re-entry), the
    LRU register file under pressure, the inlined scalar emitter,
    materialize and store_const."""
    m = mod.Machine(n_regs=3)
    a = m.alloc((5,), np.int32)
    c = m.store_const(np.arange(4, dtype=np.float32))
    for _ in range(2):                     # a re-entered scope
        m.push_loop(key="inner")
        for _ in range(5):
            m.alloc((2,), np.float32)
            m.alloc((), np.int32)
            m.emit_branch()
            m.next_iteration()
        m.pop_loop()
    regs = [m.emit_load(int(x), "i", 4) for x in a.ravel()]   # > n_regs
    r = m.emit_op("add", "i", [(SRC_REG, regs[-1]), (SRC_IMM, 3)])
    m.emit_store(int(a.ravel()[0]), r, "i", 4)
    m.emit_load(int(a.ravel()[0]), "i", 4)             # elided: in a reg
    for _ in range(6):
        m.emit_loop_overhead()
    out = m.alloc((), np.float32)
    m.emit_scalar("mul", "f", [mod.Value(c.data[1], c.addr[1]),
                               mod.Value(np.float32(2.5), None)],
                  int(out), 4)
    m.materialize(mod.Value(np.asarray([1, 2], np.int32), None))
    m.emit_scalar("max", "i", [mod.Value(np.int32(7), None),
                               mod.Value(np.int32(1), a[3])],
                  int(m.alloc((), np.int32)), 4)
    return m


def test_machines_commit_the_same_columns():
    ref, port = _drive(rtrace), _drive(ptrace)
    want = ref.b.finish(ref.n_regs).to_arrays()
    have = port.b.finish(port.n_regs, device="cpu").to_arrays()
    assert ref._arena_top == port._arena_top
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_trace_limits_raise():
    x = torch.arange(64, dtype=F32)
    with pytest.raises(RuntimeError, match="exceeded 50 instructions"):
        trace_structural(lambda x: x * 2, x, device="cpu",
                         limits=TraceLimits(max_instructions=50))
    with pytest.raises(ValueError, match="n_regs"):
        trace_structural(lambda x: x * 2, x, device="cpu", n_regs=300)


@pytest.mark.parametrize("fn,name", [
    (lambda x: torch.cumprod(x, 0), "aten.cumprod"),
    (lambda x: x.add_(1), "aten.add_"),
    (lambda x: torch.add(x, 1, out=torch.zeros(6)), "aten.add.out"),
    (lambda x: torch.arange(1, 4) + x[:3], "aten.arange.start"),
    (lambda x: torch.where(x > 0, x, 0.0) * x.max(0).values, "aten.max.dim"),
])
def test_unhandled_op_raises_naming_itself(fn, name):
    with pytest.raises(NotImplementedError, match=name.replace(".", r"\.")):
        trace_structural(fn, torch.from_numpy(FX.copy()), device="cpu")


def test_trace_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_structural(lambda x: x + 1, torch.ones(3))
