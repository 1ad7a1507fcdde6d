"""jnp's lowerings, written out in torch ops.

A jax workload's indexing and arithmetic helpers (``x[i]``,
``x.at[i].set(v)``, ``jnp.where``, ``jnp.clip``, ``//``, ``%``) lower to
short chains of primitives: a traced index is normalized against negative
values first, a literal keeps its operand position, a weak-typed value is
converted once it meets a strong one.  The trace VM commits one
instruction group per ATen op, so the torch programs spell the same chains
out with these helpers; run eagerly, each dispatches the ATen ops whose
handlers commit what jnp's lowering commits.
"""
from __future__ import annotations

import torch

I32 = torch.int32
F32 = torch.float32
# torch's index results (argmax, argmin) are int64 where jax's are int32
_JAX_DTYPE = {torch.int64: I32, torch.float64: F32}


def _typed(x: torch.Tensor) -> torch.dtype:
    """``x``'s dtype as the reference program types it."""
    return _JAX_DTYPE.get(x.dtype, x.dtype)


def imm(value, dtype=I32) -> torch.Tensor:
    """A typed literal operand: a 0-d ``aten.full``, an immediate to the
    VM, that keeps its position among an op's sources (``2 * x``
    dispatches as ``mul(x, 2)``)."""
    return torch.full((), value, dtype=dtype)


def astype(x: torch.Tensor, dtype) -> torch.Tensor:
    """``convert_element_type``, also when the dtype does not change (jnp
    converts a weak-typed value to a strong one): one ``aten._to_copy``."""
    return torch.ops.aten._to_copy.default(x, dtype=dtype)


def wrap(i: torch.Tensor, n: int) -> torch.Tensor:
    """jnp's index normalization: ``i + n`` where ``i < 0``."""
    return torch.where(i < 0, i + n, i)


def _start(i: torch.Tensor, extent: int, size: int) -> int:
    """A dynamic slice's start, read from the program and clamped so the
    window stays in bounds (``lax.dynamic_slice``)."""
    return max(0, min(int(i), extent - size))


def take(x: torch.Tensor, i: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x[i]`` (along ``dim``) for a 0-d ``i``: normalization, then a
    ``dynamic_slice`` -- a view, no load."""
    n = x.shape[dim]
    return x.select(dim, _start(wrap(i, n), n, 1))


def dynamic_slice(x: torch.Tensor, i: torch.Tensor, size: int
                  ) -> torch.Tensor:
    """``lax.dynamic_slice(x, (i,), (size,))``: normalization, then the
    window at the clamped start -- a view, no load."""
    n = x.shape[0]
    return x.narrow(0, _start(wrap(i, n), n, size), size)


def take2(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``x[i, j]`` for 0-d ``i`` and ``j``: both normalized, then the
    ``dynamic_slice`` of one element."""
    a = wrap(i, x.shape[0])
    b = wrap(j, x.shape[1])
    return x[_start(a, x.shape[0], 1), _start(b, x.shape[1], 1)]


def set_at(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x.at[i].set(v)`` for a 0-d ``i``: normalization, then a
    one-update ``scatter``."""
    return x.index_put((wrap(i, x.shape[0]).reshape(1),), v)


def set_static(x: torch.Tensor, k: int, v) -> torch.Tensor:
    """``x.at[k].set(v)`` for a Python ``k``: a ``scatter`` at a literal
    index."""
    return x.index_put((torch.full((1,), k, dtype=torch.int64),),
                       imm(v, _typed(x)))


def update_at(x: torch.Tensor, u: torch.Tensor, i: torch.Tensor
              ) -> torch.Tensor:
    """``lax.dynamic_update_slice(x, u, (i,))`` for a 0-d ``i``:
    normalization, then the in-place store of ``u`` (a ``slice_scatter``
    at the clamped start)."""
    n, size = x.shape[0], u.shape[0]
    k = _start(wrap(i, n), n, size)
    return torch.slice_scatter(x, u, 0, k, k + size)


def where(c: torch.Tensor, a, b) -> torch.Tensor:
    """``jnp.where`` (``select_n(c, b, a)``).  A Python scalar beside a
    tensor branch is converted to its dtype (a typed literal); two Python
    scalars stay 64-bit literals, as jnp hands them to its ``_where``."""
    if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        b = imm(b, _typed(a))
    elif isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        a = imm(a, _typed(b))
    return torch.where(c, a, b)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``min(hi, max(lo, x))``, literals first."""
    dt = _typed(x)
    return torch.minimum(imm(hi, dt), torch.maximum(imm(lo, dt), x))


def floor_divide(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x // d`` for int32 ``x``: jnp's truncating divide and its
    sign fix-up."""
    dv = imm(d, _typed(x))
    q = torch.div(x, dv, rounding_mode="trunc")
    fix = (torch.sign(x) != torch.sign(dv)) & (torch.fmod(x, dv) != 0)
    return torch.where(fix, q - 1, q)


def remainder(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x % d`` for int32 ``x``: jnp's guarded truncating remainder and
    its sign fix-up."""
    dv = imm(d, _typed(x))
    dv = torch.where(dv == 0, imm(1, _typed(x)), dv)
    r = torch.fmod(x, dv)
    nonzero = r != 0
    fix = ((r < 0) != (dv < 0)) & nonzero
    return torch.where(fix, r + dv, r)
