"""Trace VM: run a torch program and commit its pseudo-RISC instruction queue.

Twin of ``repro/core/trace.py``.  ``trace_structural(fn, *args)`` runs
``fn(*args)`` eagerly on plain CPU tensors under :class:`TraceInterpreter`,
a ``TorchDispatchMode`` that sees every ATen op as it executes -- the
granularity at which the reference's interpreter sees each jaxpr equation
-- and *scalarizes* it into committed instructions: loads / stores with real
addresses from a buffer arena, ALU ops over a finite register file,
immediates for literals.  There is no graph capture: loops are this
module's :func:`scan`, :func:`while_loop` and :func:`cond`, plain Python
loops that open the reference's loop scopes when the VM runs them.

Each live tensor of the program maps to a :class:`Value`: host numpy data
in the reference's dtypes (int64 -> int32 and float64 -> float32, as jax
without x64, except a literal that stays 64-bit until it meets a typed
operand, as a jaxpr literal handed to a ``jit`` does) and an address map
(``None`` for an immediate).  A tensor the VM never saw, or a Python
scalar, is an immediate, as a jaxpr literal is.  Views emit nothing; an op
with no counterpart raises ``NotImplementedError`` naming itself.

The register allocator is what makes the paper's Fig. 4 pattern variants
appear: (a) Load-Load-OP-Store, (b) Load-Imm-OP-Store for literals and
iota, (c) OP-(reg)-OP-Store when a recently produced value is still live
in a register.  The memory-response fields (level/hit/bank/MSHR) are
attached afterwards per cache geometry (:func:`attach_cache_results_batch`),
so one structural trace serves every geometry of a sweep.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.cache import (CacheConfig, CacheHierarchy, L1_32K,
                                    L2_256K)
from repro_torch.core.columnar import (MAX_REG_ID, ColumnarBuilder,
                                       ColumnarTrace, _imm_kind,
                                       resolve_device)
from repro_torch.core.isa import (IMM_FLOAT, IMM_INT, OP_CODE, OP_LOAD,
                                  OP_STORE, SRC_IMM, SRC_REG, U_BRANCH,
                                  UNIT_CODE, unit_for)

# Version of the trace VM's lowering semantics and artifact encoding.  This
# VM commits the reference's version-2 instruction stream; the store keys
# persisted artifacts by it.
TRACE_VM_VERSION = 2

# pre-resolved emission codes: op -> (unit code for int, unit code for float)
_UNIT_CODES = {op: (UNIT_CODE[unit_for(op, False)],
                    UNIT_CODE[unit_for(op, True)]) for op in OP_CODE}
_MEM_RD_CODE = UNIT_CODE[unit_for("load", False)]
_MEM_WR_CODE = UNIT_CODE[unit_for("store", False)]
_BRANCH_CODE = UNIT_CODE[U_BRANCH]

# pre-packed ColumnarBuilder meta fragments for the inlined scalar emitter
# (see Machine.emit_scalar); the encodings mirror ColumnarBuilder.add
_LOAD_META = OP_LOAD | _MEM_RD_CODE << 5
_STORE_META = OP_STORE | _MEM_WR_CODE << 5
_IMM_INT_SMETA = SRC_IMM | IMM_INT << 1


# ======================================================================
# Values: concrete data + an address map (None => immediate / generated)
# ======================================================================
class Value:
    __slots__ = ("data", "addr")

    def __init__(self, data: np.ndarray, addr: Optional[np.ndarray]):
        self.data = data
        self.addr = addr                    # int64 addresses, same shape, or None

    @property
    def in_memory(self) -> bool:
        return self.addr is not None


_TAG_CACHE: Dict[Any, str] = {}
_SIZE_CACHE: Dict[Any, int] = {}


def _dtype_tag(dt: np.dtype) -> str:
    tag = _TAG_CACHE.get(dt)
    if tag is None:
        tag = "f" if np.issubdtype(dt, np.floating) else "i"
        _TAG_CACHE[dt] = tag
    return tag


def _itemsize(dt: np.dtype) -> int:
    size = _SIZE_CACHE.get(dt)
    if size is None:
        size = int(np.dtype(dt).itemsize)
        _SIZE_CACHE[dt] = size
    return size


# ======================================================================
# The machine
# ======================================================================
@dataclasses.dataclass
class TraceLimits:
    max_instructions: int = 4_000_000


class Machine:
    """Arena + register file + the emitted CIQ (columnar).

    The machine emits *structural* columns only -- opcode, registers,
    addresses -- one scalar append per field per committed instruction
    (:class:`~repro_torch.core.columnar.ColumnarBuilder`).  The
    memory-response fields are attached afterwards by replaying the access
    stream per cache geometry (:func:`attach_cache_results_batch`).
    """

    # compiled inner loops carry induction/address-gen + branch overhead;
    # -O2 typically unrolls ~4x, so: one agen per element, one branch per 4.
    UNROLL = 4

    def __init__(self, n_regs: int = 24, limits: TraceLimits = TraceLimits(),
                 loop_overhead: bool = True):
        if not 1 <= n_regs <= MAX_REG_ID - 1:     # +1 induction register
            raise ValueError(f"n_regs must be in [1, {MAX_REG_ID - 1}] "
                             "(columnar dst packing)")
        self.b = ColumnarBuilder()
        self.limits = limits
        self.loop_overhead = loop_overhead
        self._arena_top = 0x1000
        self._ov_count = 0
        # register file (single class; dtype tag recorded per instruction)
        self.n_regs = n_regs
        self._free_regs = list(range(n_regs + 1))       # +1: induction reg
        self._ov_reg = self._free_regs.pop()            # reserved induction var
        self._reg_of_addr: "OrderedDict[int, int]" = OrderedDict()  # LRU
        self._addr_of_reg: Dict[int, int] = {}
        # pre-built argument tuple for the (constant) loop-overhead agen op
        self._ov_args = (OP_CODE["agen"], _UNIT_CODES["agen"][False], False,
                         self._ov_reg, -1, 4,
                         ((SRC_REG, self._ov_reg), (SRC_IMM, 4)))
        # pre-packed meta words for the inlined scalar emitter
        self._ov_meta = (OP_CODE["agen"] | _UNIT_CODES["agen"][False] << 5
                         | (self._ov_reg + 1) << 10 | 4 << 18)
        self._branch_meta = OP_CODE["branch"] | _BRANCH_CODE << 5 | 4 << 18
        self._loops: List[dict] = []
        self._scope_cache: Dict[Any, dict] = {}

    # ------------------------------------------------------------ arena
    # Loop-scoped buffer reuse: inside a loop body, the i-th allocation of
    # iteration t reuses the i-th allocation of iteration t-3 (triple
    # buffering keeps carries from t-1 and freshly stacked outputs intact),
    # as a compiled loop keeps its temporaries in fixed stack slots.
    LOOP_REUSE_DEPTH = 3

    def alloc(self, shape: Tuple[int, ...], dt: np.dtype) -> np.ndarray:
        n = 1
        for s in shape:
            n *= int(s)
        # temporaries pack like stack slots (8 B granularity); standalone
        # buffers outside loops stay line-aligned like heap allocations
        in_loop = bool(self._loops)
        align = 7 if in_loop else 63
        size = (n * _itemsize(dt) + align) & ~align
        base = None
        if in_loop:
            scope = self._loops[-1]
            idx = len(scope["cur"])
            hist = scope["hist"]
            if len(hist) == self.LOOP_REUSE_DEPTH and idx < len(hist[0]) \
                    and hist[0][idx][1] == size:
                base = hist[0][idx][0]                   # recycle old temp
            scope["cur"].append((base if base is not None else self._arena_top,
                                 size))
        if base is None:
            base = self._arena_top
            self._arena_top += size
        if n == 1:
            a = np.array(base, dtype=np.int64)
            return a if not shape else a.reshape(shape)
        return (base + np.arange(n, dtype=np.int64) * _itemsize(dt)).reshape(shape)

    def push_loop(self, key=None) -> None:
        """Enter a loop body scope.  ``key`` resumes the scope across
        re-entry -- an inner loop reuses the same stack slots on every run,
        exactly like a compiled loop nest."""
        if key is not None and key in self._scope_cache:
            scope = self._scope_cache[key]
            scope["cur"] = []
        else:
            scope = {"hist": [], "cur": []}
            if key is not None:
                self._scope_cache[key] = scope
        self._loops.append(scope)

    def next_iteration(self) -> None:
        scope = self._loops[-1]
        scope["hist"].append(scope["cur"])
        if len(scope["hist"]) > self.LOOP_REUSE_DEPTH:
            scope["hist"].pop(0)
        scope["cur"] = []

    def pop_loop(self) -> None:
        self._loops.pop()

    # ---------------------------------------------------------- registers
    def _alloc_reg(self) -> int:
        if self._free_regs:
            return self._free_regs.pop()
        if self._reg_of_addr:
            # evict LRU mapping; its value now lives only in memory
            addr, reg = self._reg_of_addr.popitem(last=False)
            del self._addr_of_reg[reg]
            return reg
        # nothing evictable (all regs hold in-flight temporaries): round-robin
        self._rr = (getattr(self, "_rr", -1) + 1) % self.n_regs
        return self._rr

    def _bind(self, addr: int, reg: int) -> None:
        old = self._addr_of_reg.get(reg)
        if old is not None:
            self._reg_of_addr.pop(old, None)
        self._reg_of_addr[addr] = reg
        self._addr_of_reg[reg] = addr

    def reg_holding(self, addr: int) -> Optional[int]:
        reg = self._reg_of_addr.get(addr)
        if reg is not None:
            self._reg_of_addr.move_to_end(addr)
        return reg

    # ----------------------------------------------------------- emission
    def _check_limit(self) -> None:
        if self.b.n > self.limits.max_instructions:
            raise RuntimeError(
                f"trace exceeded {self.limits.max_instructions} instructions; "
                "shrink the workload size")

    def emit_load(self, addr: int, tag: str, size: int) -> int:
        hit_reg = self.reg_holding(addr)
        if hit_reg is not None:
            return hit_reg                                # load elided (Fig.4c)
        reg = self._alloc_reg()
        self.b.add(OP_LOAD, _MEM_RD_CODE, tag == "f", reg, addr, size,
                   ((SRC_IMM, addr),))
        self._check_limit()
        self._bind(addr, reg)
        return reg

    def emit_op(self, op: str, tag: str, srcs: Sequence[Tuple[int, Any]],
                dst: Optional[int] = None) -> int:
        """``dst``: reuse a register (reduction accumulators, like a compiler)."""
        reg = self._alloc_reg() if dst is None else dst
        if dst is not None:
            old = self._addr_of_reg.pop(dst, None)
            if old is not None:
                self._reg_of_addr.pop(old, None)
        is_f = tag == "f"
        self.b.add(OP_CODE[op], _UNIT_CODES[op][is_f], is_f, reg, -1, 4,
                   tuple(srcs))
        self._check_limit()
        return reg

    def emit_store(self, addr: int, reg: int, tag: str, size: int) -> None:
        self.b.add(OP_STORE, _MEM_WR_CODE, tag == "f", -1, addr, size,
                   ((SRC_REG, reg),))
        self._check_limit()
        self._bind(addr, reg)                            # value is in reg + mem

    def emit_branch(self) -> None:
        self.b.add(OP_CODE["branch"], _BRANCH_CODE, False, -1, -1, 4, ())
        self._check_limit()

    def emit_loop_overhead(self) -> None:
        """Per-element induction/addr-gen + amortized loop branch (UNROLL)."""
        if not self.loop_overhead:
            return
        self.b.add(*self._ov_args)
        self._check_limit()
        self._ov_count += 1
        if self._ov_count % self.UNROLL == 0:
            self.emit_branch()

    def emit_scalar(self, op: str, tag: str, invals: Sequence["Value"],
                    out_addr: int, osize: int) -> None:
        """One whole scalar op -- loop overhead, operand loads, the op, the
        store -- emitted straight-line; the same instructions as
        ``emit_loop_overhead`` + ``emit_load``* + ``emit_op`` + ``emit_store``
        called in sequence, without their call overhead."""
        b = self.b
        meta_l, addr_l, srcn_l = b.meta, b.addr, b.src_n
        smeta_l, sval_l = b.src_meta, b.src_val
        n_new = 0
        if self.loop_overhead:
            meta_l.append(self._ov_meta)
            addr_l.append(-1)
            srcn_l.append(2)
            smeta_l.append(SRC_REG)
            sval_l.append(self._ov_reg)
            smeta_l.append(_IMM_INT_SMETA)
            sval_l.append(4.0)
            n_new = 1
            self._ov_count += 1
            if self._ov_count % self.UNROLL == 0:
                meta_l.append(self._branch_meta)
                addr_l.append(-1)
                srcn_l.append(0)
                n_new = 2
        reg_of_addr = self._reg_of_addr
        op_smeta: List[int] = []
        op_sval: List[float] = []
        for v in invals:
            if v.addr is None:
                d = v.data.item()
                t = type(d)
                kind = (IMM_INT if t is int else
                        IMM_FLOAT if t is float else _imm_kind(d))
                op_smeta.append(SRC_IMM | kind << 1)
                op_sval.append(float(d))
            else:
                a = v.addr.item()
                reg = reg_of_addr.get(a)
                if reg is not None:
                    reg_of_addr.move_to_end(a)      # load elided (Fig.4c)
                else:
                    dt = v.data.dtype
                    reg = self._alloc_reg()
                    meta_l.append(_LOAD_META | (_dtype_tag(dt) == "f") << 9
                                  | (reg + 1) << 10 | _itemsize(dt) << 18)
                    addr_l.append(a)
                    srcn_l.append(1)
                    smeta_l.append(_IMM_INT_SMETA)
                    sval_l.append(float(a))
                    n_new += 1
                    self._bind(a, reg)
                op_smeta.append(SRC_REG)
                op_sval.append(reg)
        is_f = tag == "f"
        rd = self._alloc_reg()
        meta_l.append(OP_CODE[op] | _UNIT_CODES[op][is_f] << 5 | is_f << 9
                      | (rd + 1) << 10 | 4 << 18)
        addr_l.append(-1)
        srcn_l.append(len(op_smeta))
        smeta_l.extend(op_smeta)
        sval_l.extend(op_sval)
        meta_l.append(_STORE_META | is_f << 9 | osize << 18)
        addr_l.append(out_addr)
        srcn_l.append(1)
        smeta_l.append(SRC_REG)
        sval_l.append(rd)
        b.n += n_new + 2
        self._bind(out_addr, rd)
        self._check_limit()

    # ------------------------------------------------- value-level helpers
    def materialize(self, val: Value) -> Value:
        """Give an immediate-only value a memory buffer (mov+store each elem)."""
        if val.in_memory:
            return val
        data = np.asarray(val.data)
        addr = self.alloc(data.shape, data.dtype)
        tag = _dtype_tag(data.dtype)
        size = _itemsize(data.dtype)
        for d, a in zip(data.ravel().tolist(), addr.ravel().tolist()):
            r = self.emit_op("mov", tag, ((SRC_IMM, d),))
            self.emit_store(a, r, tag, size)
        return Value(data, addr)

    def store_const(self, arr: np.ndarray) -> Value:
        """Program inputs and constants live in memory but cost no trace
        instructions (the loader wrote them, not the program)."""
        arr = np.asarray(arr)
        return Value(arr, self.alloc(arr.shape, arr.dtype))


# ======================================================================
# dtypes: the reference's (jax without x64)
# ======================================================================
_NP_DTYPE = {
    torch.bool: np.dtype(np.bool_), torch.uint8: np.dtype(np.uint8),
    torch.int8: np.dtype(np.int8), torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64),
    torch.float16: np.dtype(np.float16), torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}
_CANON = {np.dtype(np.int64): np.dtype(np.int32),
          np.dtype(np.float64): np.dtype(np.float32)}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    try:
        return _NP_DTYPE[dtype]
    except KeyError:
        raise NotImplementedError(
            f"trace VM: unsupported dtype {dtype}") from None


def canonical_dtype(dtype) -> np.dtype:
    """The VM's numpy dtype for a torch or numpy dtype: int64 -> int32 and
    float64 -> float32, as jax canonicalizes without x64."""
    dt = _np_dtype(dtype) if isinstance(dtype, torch.dtype) else np.dtype(dtype)
    return _CANON.get(dt, dt)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor in the VM's (canonical) dtype."""
    a = t.detach().cpu().numpy()
    return a.astype(canonical_dtype(a.dtype), copy=False)


# ======================================================================
# ATen op -> primitive -> (VM op, numpy oracle), the reference's tables
# ======================================================================
_NP_BINOP = {
    "add": np.add, "sub": np.subtract, "mul": np.multiply,
    "div": lambda a, b: np.divide(a, b) if np.issubdtype(np.result_type(a, b), np.floating)
           else np.floor_divide(a, b),
    "max": np.maximum, "min": np.minimum,
    "and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor,
    "rem": np.remainder, "pow": np.power,
    "shift_left": np.left_shift, "shift_right_arithmetic": np.right_shift,
    "lt": np.less, "le": np.less_equal, "gt": np.greater,
    "ge": np.greater_equal, "eq": np.equal, "ne": np.not_equal,
}
_NP_UNOP = {
    "not": np.logical_not, "neg": np.negative, "abs": np.abs, "sign": np.sign,
    "exp": np.exp, "log": np.log, "tanh": np.tanh,
    "logistic": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "sqrt": np.sqrt, "rsqrt": lambda x: 1.0 / np.sqrt(x),
    "floor": np.floor, "ceil": np.ceil, "round": np.round,
    "exp2": np.exp2, "log1p": np.log1p, "expm1": np.expm1,
    "cos": np.cos, "sin": np.sin, "tan": np.tan,
}
# primitive -> the VM op it commits
_VM_OP = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "max": "max", "min": "min", "and": "and", "or": "or", "xor": "xor",
    "not": "not", "neg": "neg", "abs": "abs", "sign": "sign",
    "exp": "exp", "log": "log", "tanh": "tanh", "logistic": "sigmoid",
    "sqrt": "sqrt", "rsqrt": "rsqrt", "floor": "floor", "ceil": "floor",
    "round": "round", "rem": "rem", "pow": "pow",
    "shift_left": "shl", "shift_right_arithmetic": "shr",
    "exp2": "exp", "log1p": "log", "expm1": "exp", "cos": "exp",
    "sin": "exp", "tan": "exp",
    "lt": "cmp", "le": "cmp", "gt": "cmp", "ge": "cmp", "eq": "cmp",
    "ne": "cmp",
}
_ATEN_BINARY = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "maximum": "max", "minimum": "min",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "logical_and": "and", "logical_or": "or", "logical_xor": "xor",
    "fmod": "rem", "remainder": "rem", "pow": "pow",
    "bitwise_left_shift": "shift_left",
    "bitwise_right_shift": "shift_right_arithmetic",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
}
_ATEN_UNARY = {
    "bitwise_not": "not", "logical_not": "not", "neg": "neg", "abs": "abs",
    "sign": "sign", "exp": "exp", "log": "log", "tanh": "tanh",
    "sigmoid": "logistic", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "floor": "floor", "ceil": "ceil", "round": "round", "exp2": "exp2",
    "log1p": "log1p", "expm1": "expm1", "cos": "cos", "sin": "sin",
    "tan": "tan",
}
# full-tensor or per-dim reductions -> (VM op, numpy oracle)
_REDUCE = {
    "sum": ("add", np.sum), "prod": ("mul", np.prod),
    "amax": ("max", np.max), "max": ("max", np.max),
    "amin": ("min", np.min), "min": ("min", np.min),
}
# ops that reinterpret a tensor without moving it: no instructions
_RESHAPES = frozenset(("view", "_unsafe_view", "squeeze", "unsqueeze"))
_SAME = frozenset(("clone", "alias", "detach", "lift_fresh"))
_LITERALS = frozenset(("full", "zeros", "ones", "scalar_tensor",
                       "full_like", "zeros_like", "ones_like", "new_full",
                       "new_zeros", "new_ones"))
# reads of a value by the program (index arithmetic, branch conditions):
# no instructions, as the reference's dynamic_slice start and cond index
_READS = frozenset(("_local_scalar_dense", "is_nonzero"))


def _norm_dims(dims, ndim: int) -> Tuple[int, ...]:
    if dims is None:
        return tuple(range(ndim))
    if isinstance(dims, int):
        dims = [dims]
    if len(dims) == 0:
        return tuple(range(ndim))
    return tuple(sorted(d % ndim if ndim else 0 for d in dims))


def _arg(args, kwargs, i: int, name: str, default=None):
    """Argument ``i`` (or keyword ``name``) of an ATen call."""
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


# the VM tracing on this thread (the dispatch mode stack is thread-local)
_ACTIVE = threading.local()


def _active() -> Optional["TraceInterpreter"]:
    return getattr(_ACTIVE, "vm", None)


class TraceInterpreter(TorchDispatchMode):
    """Scalarizes every ATen op of an eagerly running program into a
    :class:`Machine`.

    The program runs on plain CPU tensors; the mode runs each op, then
    emits what the reference's handler for its jaxpr counterpart emits and
    maps the op's output tensor to its :class:`Value`.  The map holds the
    tensors it keys (by ``id``), so no key is reused during a trace; a
    tensor subclass carrying its Value would have to wrap every factory
    result and input, where the mode sees factories as ops and leaves the
    program's tensors plain."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the VM is never compiled, so its dispatch needs no dynamo guard;
        # the guard's first call imports torch._dynamo (seconds in a cold
        # process) and it wraps every op after that
        return False

    def __init__(self, machine: Machine):
        super().__init__()
        self.m = machine
        self._vals: Dict[int, Value] = {}
        self._keep: List[torch.Tensor] = []
        self._paused = 0
        self._handlers: Dict[Any, Callable] = {}

    # ------------------------------------------------------- tensor map
    def value(self, x) -> Value:
        """``x``'s Value: a mapped tensor's, or an immediate."""
        if isinstance(x, torch.Tensor):
            v = self._vals.get(id(x))
            if v is None:                          # never seen: a literal
                v = Value(_host(x), None)
            return v
        return Value(np.asarray(x), None)

    def bind(self, t: torch.Tensor, v: Value) -> None:
        self._vals[id(t)] = v
        self._keep.append(t)

    def truth(self, x) -> bool:
        """A branch condition as the VM computed it."""
        if isinstance(x, torch.Tensor):
            return bool(np.asarray(self.value(x).data))
        return bool(x)

    def __enter__(self):
        if _active() is not None:
            raise RuntimeError("trace VM: a trace is already running on "
                               "this thread")
        _ACTIVE.vm = self
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.vm = None
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self):
        """Run torch ops without tracing them (the loop helpers' own
        slicing and stacking, which the reference does on its Values)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # --------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        handler = self._handlers.get(func)
        if handler is None:
            handler = self._handlers[func] = self._handler_for(func)
        res = handler(self, func, out, args, kwargs)
        if res is not None:
            if isinstance(out, (tuple, list)):
                for t, v in zip(out, res):
                    self.bind(t, v)
            else:
                self.bind(out, res)
        return out

    @classmethod
    def _handler_for(cls, func) -> Callable:
        """The handler of one ATen op, as ``handler(vm, func, out, args,
        kwargs)``: a plain function, so the VM's handler table holds no
        reference back to the VM (no cycle for the garbage collector)."""
        name, ovl = func._opname, func._overloadname
        if ovl == "out" or ovl.endswith("_out"):   # writes a given tensor
            return cls._unsupported
        if name == "pow" and ovl == "Tensor_Scalar":
            return cls._integer_pow
        if name in _ATEN_BINARY:
            prim = _ATEN_BINARY[name]
            return lambda vm, f, out, a, kw: vm._binary(
                f, prim, a[0], a[1], out, kw)
        if name == "rsub":                         # other - self
            return lambda vm, f, out, a, kw: vm._binary(
                f, "sub", a[1], a[0], out, kw)
        if name in _ATEN_UNARY:
            prim = _ATEN_UNARY[name]
            return lambda vm, f, out, a, kw: vm._unary(prim, a[0], out)
        if name in _RESHAPES:
            return cls._reshape_view
        if name in _SAME:
            return lambda vm, f, out, a, kw: vm.value(a[0])
        if name in _LITERALS:
            return cls._literal
        if name in _READS:
            return lambda vm, f, out, a, kw: None
        if name in _REDUCE:
            return cls._reduction
        table = {
            "expand": cls._expand, "select": cls._select,
            "slice": cls._slice, "permute": cls._permute,
            "t": cls._permute, "transpose": cls._permute,
            "unfold": cls._unfold, "flip": cls._flip,
            "arange": cls._arange, "_to_copy": cls._to_copy,
            "where": cls._where, "clamp": cls._clamp,
            "argmax": cls._arg_reduction, "argmin": cls._arg_reduction,
            "mm": cls._matmul, "mv": cls._matmul, "dot": cls._matmul,
            "bmm": cls._matmul, "cat": cls._cat,
            "constant_pad_nd": cls._pad, "index": cls._index,
            "index_put": cls._index_put, "slice_scatter": cls._slice_scatter,
            "sort": cls._sort, "cumsum": cls._cumsum,
        }
        h = table.get(name)
        if h is None or (name == "where" and ovl != "self") \
                or (name == "index" and ovl != "Tensor"):
            return cls._unsupported
        return h

    def _unsupported(self, func, out, args, kwargs):
        raise NotImplementedError(
            f"trace VM: unsupported ATen op '{func}' -- extend "
            "repro_torch/core/trace.py or rewrite the program")

    # ----------------------------------------------------------- operands
    def _promote(self, x, dt: np.dtype) -> Value:
        """An operand in dtype ``dt``: a Python scalar is a typed literal,
        and a tensor of another dtype gets jnp's explicit conversion."""
        if not isinstance(x, torch.Tensor):
            return Value(np.asarray(x, dtype=dt), None)
        v = self.value(x)
        return v if np.asarray(v.data).dtype == dt else self._convert_to(v, dt)

    def _convert_to(self, v: Value, dt: np.dtype) -> Value:
        """``convert_element_type``."""
        out = np.asarray(v.data).astype(dt)
        if v.addr is None:
            return Value(out, None)
        # conversion happens in-register per element (mov)
        return self._elementwise("mov", [v], out)

    # --------------------------------------------------- elementwise family
    def _binary(self, func, prim: str, a, b, out, kwargs) -> Value:
        if kwargs.get("alpha", 1) != 1:
            raise NotImplementedError(f"trace VM: '{func}' with alpha != 1")
        if prim == "div" and kwargs.get("rounding_mode") is None:
            dt = canonical_dtype(out.dtype)                # true division
        else:
            dt = canonical_dtype(torch.result_type(a, b))
        va, vb = self._promote(a, dt), self._promote(b, dt)
        res = _NP_BINOP[prim](np.asarray(va.data), np.asarray(vb.data))
        res = np.asarray(res, dtype=canonical_dtype(out.dtype))
        return self._elementwise(_VM_OP[prim], [va, vb], res)

    def _unary(self, prim: str, x, out) -> Value:
        v = self.value(x)
        res = np.asarray(_NP_UNOP[prim](np.asarray(v.data)),
                         dtype=canonical_dtype(out.dtype))
        return self._elementwise(_VM_OP[prim], [v], res)

    def _integer_pow(self, func, out, args, kwargs) -> Value:
        """``x ** k`` for an integer ``k`` (``torch.square`` too): the
        reference's ``integer_pow`` / ``square``, one multiply per element."""
        y = args[1]
        if isinstance(y, bool) or not isinstance(y, int):
            return self._binary(func, "pow", args[0], y, out, kwargs)
        v = self.value(args[0])
        return self._elementwise("mul", [v], np.power(np.asarray(v.data), y))

    def _to_copy(self, func, out, args, kwargs) -> Value:
        return self._convert_to(self.value(args[0]),
                                canonical_dtype(out.dtype))

    def _where(self, func, out, args, kwargs) -> Value:
        """``select_n(c, b, a)``, as ``jnp.where(c, a, b)`` lowers; the
        result has the cases' numpy dtype, so two 64-bit literals select a
        64-bit value, as the reference's two weak literals do."""
        c, a, b = (self.value(x) for x in args[:3])
        dt = np.result_type(np.asarray(a.data).dtype,
                            np.asarray(b.data).dtype)
        res = np.where(np.asarray(c.data), np.asarray(a.data),
                       np.asarray(b.data)).astype(dt)
        return self._elementwise("sel", [c, b, a], res)

    def _clamp(self, func, out, args, kwargs) -> Value:
        """``clamp(lo, x, hi)`` with both bounds, as ``lax.clamp``."""
        lo = _arg(args, kwargs, 1, "min")
        hi = _arg(args, kwargs, 2, "max")
        if lo is None or hi is None:
            raise NotImplementedError(
                f"trace VM: '{func}' needs both bounds (write "
                "torch.minimum / torch.maximum for one)")
        dt = canonical_dtype(out.dtype)
        x, lo, hi = (self._promote(v, dt) for v in (args[0], lo, hi))
        res = np.clip(np.asarray(x.data), np.asarray(lo.data),
                      np.asarray(hi.data))
        return self._elementwise("sel", [lo, x, hi], res)

    def _cumsum(self, func, out, args, kwargs) -> Value:
        # sequential scan along axis: acc chains (variant c)
        x = self._promote(args[0], canonical_dtype(out.dtype))
        axis = _arg(args, kwargs, 1, "dim") % max(np.asarray(x.data).ndim, 1)
        res = np.cumsum(np.asarray(x.data), axis=axis).astype(
            canonical_dtype(out.dtype))
        return self._elementwise("add", [x], res)

    def _elementwise(self, op: str, invals: List[Value], out_data: np.ndarray
                     ) -> Value:
        m = self.m
        out_data = np.asarray(out_data)
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        tag = _dtype_tag(out_data.dtype)
        osize = _itemsize(out_data.dtype)
        n = out_data.size
        if n == 1:
            # scalar fast path: pointer-heavy kernels (LCS, mcf) lower almost
            # every op to one committed instruction
            m.emit_scalar(op, tag, invals, out_addr.item(), osize)
            return Value(out_data, out_addr)
        # operands broadcast to the output shape (ATen's implicit
        # broadcasting is jax's explicit broadcast_in_dim: a view)
        srcs_flat = []
        for v in invals:
            data = np.asarray(v.data)
            if data.shape == out_data.shape:
                flat_d = data.ravel().tolist()
            elif data.size == 1:
                flat_d = [data.ravel()[0].item()] * n
            else:
                flat_d = np.broadcast_to(data, out_data.shape).ravel().tolist()
            if v.addr is None:
                flat_a = None
            elif v.addr.shape == out_data.shape:
                flat_a = v.addr.ravel().tolist()
            elif v.addr.size == 1:
                flat_a = [int(v.addr.ravel()[0])] * n
            else:
                flat_a = np.broadcast_to(v.addr,
                                         out_data.shape).ravel().tolist()
            srcs_flat.append((flat_d, flat_a, _dtype_tag(data.dtype),
                              _itemsize(data.dtype)))
        oaddr_flat = out_addr.ravel().tolist()
        emit_overhead = m.emit_loop_overhead
        emit_load, emit_op, emit_store = m.emit_load, m.emit_op, m.emit_store
        for i in range(n):
            emit_overhead()
            srcs = []
            for data, addr, stag, ssize in srcs_flat:
                if addr is None:
                    srcs.append((SRC_IMM, data[i]))
                else:
                    srcs.append((SRC_REG, emit_load(addr[i], stag, ssize)))
            rd = emit_op(op, tag, srcs)
            emit_store(oaddr_flat[i], rd, tag, osize)
        return Value(out_data, out_addr)

    # ----------------------------------------------------------- reduction
    def _reduction(self, func, out, args, kwargs) -> Value:
        name = func._opname
        op, np_fn = _REDUCE[name]
        x = args[0]
        nd = np.asarray(self.value(x).data).ndim
        dims = None if (name in ("sum", "prod", "max", "min")
                        and func._overloadname == "default") \
            else _arg(args, kwargs, 1, "dim")
        if name in ("max", "min") and dims is not None:
            raise NotImplementedError(
                f"trace VM: '{func}' returns indices; use torch.a{name}")
        axes = _norm_dims(dims, nd)
        dt = canonical_dtype(out.dtype)
        v = self._promote(x, dt) if name in ("sum", "prod") else self.value(x)
        xd = np.asarray(v.data)
        res = np.asarray(np_fn(xd, axis=axes), dtype=dt).reshape(out.shape)
        init = {"add": 0,
                "max": float("-inf") if xd.dtype.kind == "f"
                else np.iinfo(xd.dtype).min,
                "min": float("inf") if xd.dtype.kind == "f"
                else np.iinfo(xd.dtype).max,
                "mul": 1}[op]
        return self._reduce(op, v, axes, res, init)

    def _reduce(self, op: str, inval: Value, axes: Tuple[int, ...],
                out_data: np.ndarray, init_imm) -> Value:
        """Sequential accumulation -- acc stays in a register (Fig. 4c chains)."""
        m = self.m
        out_data = np.asarray(out_data)
        x = np.asarray(inval.data)
        tag = _dtype_tag(out_data.dtype)
        osize = _itemsize(out_data.dtype)
        ssize = _itemsize(x.dtype)
        keep = [a for a in range(x.ndim) if a not in axes]
        perm = keep + list(axes)
        red_n = int(np.prod([x.shape[a] for a in axes])) if axes else 1
        xa = (np.transpose(inval.addr, perm).reshape(-1, red_n).tolist()
              if inval.addr is not None else None)
        xd = np.transpose(x, perm).reshape(-1, red_n)
        xd_l = xd.tolist()
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        oaddr_flat = out_addr.ravel().tolist()
        emit_overhead = m.emit_loop_overhead
        emit_load, emit_op, emit_store = m.emit_load, m.emit_op, m.emit_store
        for i in range(xd.shape[0]):
            acc = emit_op("mov", tag, ((SRC_IMM, init_imm),))
            row_a = xa[i] if xa is not None else None
            row_d = xd_l[i]
            for j in range(red_n):
                emit_overhead()
                if row_a is None:
                    src = (SRC_IMM, row_d[j])
                else:
                    src = (SRC_REG, emit_load(row_a[j], tag, ssize))
                acc = emit_op(op, tag, ((SRC_REG, acc), src), dst=acc)
            emit_store(oaddr_flat[i], acc, tag, osize)
        return Value(out_data, out_addr)

    def _arg_reduction(self, func, out, args, kwargs) -> Value:
        v = self.value(args[0])
        dim = _arg(args, kwargs, 1, "dim")
        if dim is None:                           # over the flattened input
            v = Value(np.asarray(v.data).ravel(),
                      v.addr.ravel() if v.addr is not None else None)
            dim = 0
        xd = np.asarray(v.data)
        axis = dim % max(xd.ndim, 1)
        np_fn = np.argmax if func._opname == "argmax" else np.argmin
        res = np.asarray(np_fn(xd, axis=axis), dtype=canonical_dtype(out.dtype))
        r = self._argreduce(v, axis, res)
        return Value(r.data.reshape(out.shape), r.addr.reshape(out.shape))

    def _argreduce(self, inval: Value, axis: int, out_data: np.ndarray
                   ) -> Value:
        m = self.m
        x = np.asarray(inval.data)
        perm = [a for a in range(x.ndim) if a != axis] + [axis]
        red_n = x.shape[axis]
        xa = (np.transpose(inval.addr, perm).reshape(-1, red_n)
              if inval.addr is not None else None)
        xd = np.transpose(x, perm).reshape(-1, red_n)
        out_data = np.asarray(out_data)
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        oaddr_flat = out_addr.ravel()
        tag = _dtype_tag(x.dtype)
        ssize = _itemsize(x.dtype)
        for i in range(xd.shape[0]):
            best = m.emit_op("mov", tag, ((SRC_IMM, xd[i, 0].item()),)) \
                if xa is None else m.emit_load(int(xa[i, 0]), tag, ssize)
            bidx = m.emit_op("mov", "i", ((SRC_IMM, 0),))
            for j in range(1, red_n):
                m.emit_loop_overhead()
                if xa is None:
                    src = (SRC_IMM, xd[i, j].item())
                    cur = m.emit_op("mov", tag, (src,))
                else:
                    cur = m.emit_load(int(xa[i, j]), tag, ssize)
                c = m.emit_op("cmp", tag, ((SRC_REG, cur), (SRC_REG, best)))
                best = m.emit_op("sel", tag, ((SRC_REG, c), (SRC_REG, cur),
                                              (SRC_REG, best)), dst=best)
                bidx = m.emit_op("sel", "i", ((SRC_REG, c), (SRC_IMM, j),
                                              (SRC_REG, bidx)), dst=bidx)
            m.emit_store(int(oaddr_flat[i]), bidx, "i",
                         _itemsize(out_data.dtype))
        return Value(out_data, out_addr)

    # -------------------------------------------------------- dot_general
    _DNUMS = {"mm": (((1,), (0,)), ((), ())),
              "mv": (((1,), (0,)), ((), ())),
              "dot": (((0,), (0,)), ((), ())),
              "bmm": (((2,), (1,)), ((0,), (0,)))}

    def _matmul(self, func, out, args, kwargs) -> Value:
        # the product's values come from the op itself, as the reference
        # takes them from XLA; they are never immediates
        res = _host(out)
        return self._dot_general(self.value(args[0]), self.value(args[1]),
                                 self._DNUMS[func._opname], res)

    def _dot_general(self, a: Value, b: Value, dnums, out_data: np.ndarray
                     ) -> Value:
        m = self.m
        (lc, rc), (lb, rb) = dnums
        A, B = np.asarray(a.data), np.asarray(b.data)

        def order(x, batch, contract):
            keep = [i for i in range(x.ndim) if i not in batch + contract]
            return list(batch) + keep + list(contract)

        pa, pb = order(A, tuple(lb), tuple(lc)), order(B, tuple(rb), tuple(rc))
        nb = int(np.prod([A.shape[i] for i in lb])) if lb else 1
        K = int(np.prod([A.shape[i] for i in lc])) if lc else 1
        Mm = A.size // (nb * K)
        Nn = B.size // (nb * K)
        Ad = np.transpose(A, pa).reshape(nb, Mm, K)
        Bd = np.transpose(B, pb).reshape(nb, Nn, K)
        Aa = (np.transpose(a.addr, pa).reshape(nb, Mm, K)
              if a.addr is not None else None)
        Ba = (np.transpose(b.addr, pb).reshape(nb, Nn, K)
              if b.addr is not None else None)
        out_data = np.asarray(out_data)
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        oaddr = out_addr.reshape(nb, Mm, Nn)
        tag = _dtype_tag(out_data.dtype)
        asz, bsz = _itemsize(A.dtype), _itemsize(B.dtype)
        osize = _itemsize(out_data.dtype)
        Ad_l, Bd_l = Ad.tolist(), Bd.tolist()
        Aa_l = Aa.tolist() if Aa is not None else None
        Ba_l = Ba.tolist() if Ba is not None else None
        oaddr_l = oaddr.tolist()
        emit_overhead = m.emit_loop_overhead
        emit_load, emit_op, emit_store = m.emit_load, m.emit_op, m.emit_store
        for bi in range(nb):
            for i in range(Mm):
                a_row = Aa_l[bi][i] if Aa_l is not None else None
                ad_row = Ad_l[bi][i]
                for j in range(Nn):
                    b_row = Ba_l[bi][j] if Ba_l is not None else None
                    bd_row = Bd_l[bi][j]
                    acc = emit_op("mov", tag, ((SRC_IMM, 0),))
                    for k in range(K):
                        emit_overhead()
                        sa = ((SRC_REG, emit_load(a_row[k], tag, asz))
                              if a_row is not None else (SRC_IMM, ad_row[k]))
                        sb = ((SRC_REG, emit_load(b_row[k], tag, bsz))
                              if b_row is not None else (SRC_IMM, bd_row[k]))
                        prod = emit_op("mul", tag, (sa, sb))
                        acc = emit_op("add", tag,
                                      ((SRC_REG, acc), (SRC_REG, prod)),
                                      dst=acc)
                    emit_store(oaddr_l[bi][i][j], acc, tag, osize)
        return Value(out_data, out_addr)

    # -------------------------------------------------------------- views
    @staticmethod
    def _view(v: Value, dim: int, index) -> Value:
        """``v`` indexed along ``dim`` (an int or a slice): a view."""
        data = np.asarray(v.data)
        sl = (slice(None),) * (dim % data.ndim) + (index,)
        return Value(data[sl], v.addr[sl] if v.addr is not None else None)

    def _reshape_view(self, func, out, args, kwargs) -> Value:
        v = self.value(args[0])
        shape = tuple(out.shape)
        return Value(np.asarray(v.data).reshape(shape),
                     v.addr.reshape(shape) if v.addr is not None else None)

    def _expand(self, func, out, args, kwargs) -> Value:
        v = self.value(args[0])
        shape = tuple(out.shape)
        return Value(np.broadcast_to(np.asarray(v.data), shape),
                     np.broadcast_to(v.addr, shape)
                     if v.addr is not None else None)

    def _select(self, func, out, args, kwargs) -> Value:
        # a slice at a read index: the reference's dynamic_slice, a view
        return self._view(self.value(args[0]), args[1], args[2])

    def _slice(self, func, out, args, kwargs) -> Value:
        dim = _arg(args, kwargs, 1, "dim", 0)
        start = _arg(args, kwargs, 2, "start")
        end = _arg(args, kwargs, 3, "end")
        step = _arg(args, kwargs, 4, "step", 1)
        return self._view(self.value(args[0]), dim, slice(start, end, step))

    def _permute(self, func, out, args, kwargs) -> Value:
        v = self.value(args[0])
        nd = np.asarray(v.data).ndim
        name = func._opname
        if name == "permute":
            perm = [d % nd for d in args[1]]
        else:
            perm = list(range(nd))
            if nd >= 2:
                d0, d1 = ((args[1] % nd, args[2] % nd)
                          if name == "transpose" else (0, 1))
                perm[d0], perm[d1] = perm[d1], perm[d0]
        return Value(np.transpose(v.data, perm),
                     np.transpose(v.addr, perm) if v.addr is not None else None)

    def _unfold(self, func, out, args, kwargs) -> Value:
        from numpy.lib.stride_tricks import sliding_window_view
        v = self.value(args[0])
        _, dim, size, step = args[:4]
        data = np.asarray(v.data)
        dim %= max(data.ndim, 1)
        sl = (slice(None),) * dim + (slice(None, None, step),)

        def win(a):
            return sliding_window_view(a, size, axis=dim)[sl]
        return Value(win(data), win(v.addr) if v.addr is not None else None)

    def _flip(self, func, out, args, kwargs) -> Value:
        # the reference's rev: a view
        v = self.value(args[0])
        nd = np.asarray(v.data).ndim
        dims = _norm_dims(args[1], nd)
        sl = tuple(slice(None, None, -1) if i in dims else slice(None)
                   for i in range(nd))
        return Value(np.asarray(v.data)[sl],
                     v.addr[sl] if v.addr is not None else None)

    # ---------------------------------------------------- literals, iota
    def _literal(self, func, out, args, kwargs) -> Value:
        """A factory's tensor is an immediate in the dtype it was asked
        for.  ``scalar_tensor`` wraps a Python scalar (``torch.where(c, 0,
        1)``): a weak literal, 64-bit until it meets a typed operand, as a
        literal handed to a jaxpr ``jit`` is."""
        if func._opname == "scalar_tensor":
            return Value(np.asarray(args[0]), None)
        return Value(out.detach().numpy().copy(), None)

    def _arange(self, func, out, args, kwargs) -> Value:
        if func._overloadname != "default":
            raise NotImplementedError(
                f"trace VM: '{func}': write start + torch.arange(n), as jnp "
                "lowers arange(start, stop)")
        return Value(_host(out), None)                # generated: immediates

    # ------------------------------------------------------- copy helpers
    def _copy_to_new_buffer(self, src: Value, out_data: np.ndarray) -> Value:
        """Materializing copy (gathered immediates, sorts): load+store."""
        m = self.m
        out_data = np.asarray(out_data)
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        tag = _dtype_tag(out_data.dtype)
        size = _itemsize(out_data.dtype)
        sa = src.addr.ravel() if src.addr is not None else None
        sd = np.asarray(src.data).ravel()
        oa = out_addr.ravel()
        for i in range(out_data.size):
            m.emit_loop_overhead()
            if sa is None:
                r = m.emit_op("mov", tag, ((SRC_IMM, sd[i].item()),))
            else:
                r = m.emit_load(int(sa[i]), tag, size)
            m.emit_store(int(oa[i]), r, tag, size)
        return Value(out_data, out_addr)

    def _concat_copy(self, fake: Value, out: np.ndarray) -> Value:
        m = self.m
        out_addr = m.alloc(out.shape, out.dtype)
        tag = _dtype_tag(out.dtype)
        size = _itemsize(out.dtype)
        sa = fake.addr.ravel()
        sd = out.ravel()
        oa = out_addr.ravel()
        for i in range(out.size):
            m.emit_loop_overhead()
            if sa[i] < 0:
                r = m.emit_op("mov", tag, ((SRC_IMM, sd[i].item()),))
            else:
                r = m.emit_load(int(sa[i]), tag, size)
            m.emit_store(int(oa[i]), r, tag, size)
        return Value(out, out_addr)

    def _cat(self, func, out, args, kwargs) -> Value:
        dt = canonical_dtype(out.dtype)
        vals = [self._promote(t, dt) for t in args[0]]
        datas = [np.asarray(v.data) for v in vals]
        dim = _arg(args, kwargs, 1, "dim", 0) % max(datas[0].ndim, 1)
        res = np.concatenate(datas, axis=dim)
        if all(v.addr is None for v in vals):
            return Value(res, None)
        # one materializing copy; elements with addr -1 come from immediates
        src_addr = np.concatenate(
            [v.addr if v.addr is not None else np.full(d.shape, -1, np.int64)
             for v, d in zip(vals, datas)], axis=dim)
        return self._concat_copy(Value(res, src_addr), res)

    def _pad(self, func, out, args, kwargs) -> Value:
        v = self.value(args[0])
        pad = args[1]
        value = _arg(args, kwargs, 2, "value", 0)
        data = np.asarray(v.data)
        nd = data.ndim
        cfg = [(0, 0)] * nd
        for i in range(len(pad) // 2):
            cfg[nd - 1 - i] = (pad[2 * i], pad[2 * i + 1])
        if any(lo < 0 or hi < 0 for lo, hi in cfg):
            raise NotImplementedError(
                f"trace VM: '{func}' with negative padding")
        dt = canonical_dtype(out.dtype)
        res = np.pad(data, cfg, constant_values=np.asarray(value, dt)).astype(dt)
        addr = np.full(res.shape, -1, np.int64)
        if v.addr is not None:
            sl = tuple(slice(lo, lo + s) for (lo, _), s in zip(cfg, data.shape))
            addr[sl] = v.addr
        return self._concat_copy(Value(res, addr), res)

    def _sort(self, func, out, args, kwargs) -> List[Value]:
        """One copy of the sorted values (``lax.sort`` of one operand); the
        indices are generated, as an argsort's iota operand is."""
        v = self.value(args[0])
        if func._overloadname == "stable":
            dim = kwargs.get("dim", -1)
            desc = kwargs.get("descending", False)
        else:
            dim = _arg(args, kwargs, 1, "dim", -1)
            desc = _arg(args, kwargs, 2, "descending", False)
        xd = np.asarray(v.data)
        axis = dim % max(xd.ndim, 1)
        perm = np.argsort(-xd if desc else xd, axis=axis, kind="stable")
        values = np.take_along_axis(xd, perm, axis=axis)
        idx = perm.astype(canonical_dtype(out[1].dtype))
        return [self._copy_to_new_buffer(v, values), Value(idx, None)]

    # ------------------------------------------------------------- gather
    def _index_operand(self, indices: List[Value]) -> Optional[Value]:
        """The gather/scatter ``indices`` operand.  Immediate index tensors
        (iota) are batching dimensions; the one index in memory is the
        operand as it stands, and several are broadcast and concatenated
        along a new last axis, as jnp indexing does (a materializing copy)."""
        if not indices:
            return None
        mem = [v for v in indices if v.addr is not None]
        if not mem:
            return indices[0]
        if len(mem) == 1:
            return mem[0]
        shape = np.broadcast_shapes(*(np.asarray(v.data).shape for v in mem))
        datas = [np.broadcast_to(np.asarray(v.data), shape)[..., None]
                 for v in mem]
        addrs = [np.broadcast_to(v.addr, shape)[..., None] for v in mem]
        res = np.concatenate(datas, axis=-1)
        return self._concat_copy(Value(res, np.concatenate(addrs, axis=-1)),
                                 res)

    @staticmethod
    def _index_key(shape, indices: List[Optional[Value]]):
        """numpy advanced-indexing key, each index clipped into range (the
        primitives' CLIP mode)."""
        key = []
        for d, v in enumerate(indices):
            if v is None:
                key.append(slice(None))
            else:
                key.append(np.clip(np.asarray(v.data).astype(np.int64), 0,
                                   shape[d] - 1))
        return tuple(key)

    def _index(self, func, out, args, kwargs) -> Value:
        """``x[i, ...]`` with index tensors: the reference's ``gather``."""
        operand = self.value(args[0])
        indices = [None if i is None else self.value(i) for i in args[1]]
        od = np.asarray(operand.data)
        key = self._index_key(od.shape, indices)
        res = od[key]
        index_srcs = self._index_operand([v for v in indices if v is not None])
        if operand.addr is None:
            return self._copy_to_new_buffer(Value(res, None), res)
        return self._gather_pointer_chase(operand, res, operand.addr[key],
                                          index_srcs)

    def _gather_pointer_chase(self, operand: Value, out_data: np.ndarray,
                              gathered_addrs: np.ndarray,
                              index_srcs: Optional[Value]) -> Value:
        """Emit idx-load + address-arith + data-load per gathered element."""
        m = self.m
        out_data = np.asarray(out_data)
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        tag = _dtype_tag(out_data.dtype)
        size = _itemsize(out_data.dtype)
        ia = (index_srcs.addr.ravel() if index_srcs is not None
              and index_srcs.addr is not None else None)
        id_flat = (np.asarray(index_srcs.data).ravel()
                   if index_srcs is not None else None)
        ga = gathered_addrs.ravel()
        oa = out_addr.ravel()
        n_idx = len(id_flat) if id_flat is not None else 0
        for i in range(out_data.size):
            m.emit_loop_overhead()
            # the index value itself is loaded (pointer chasing), then one
            # address-arith op, then the dependent data load
            if ia is not None:
                ri = m.emit_load(int(ia[i % n_idx]), "i", 4)
                m.emit_op("agen", "i", ((SRC_REG, ri), (SRC_IMM, 0)))
            r = m.emit_load(int(ga[i]), tag, size)
            m.emit_store(int(oa[i]), r, tag, size)
        return Value(out_data, out_addr)

    # ------------------------------------------------------------ scatter
    def _index_put(self, func, out, args, kwargs) -> Value:
        """``x.index_put(indices, values)``: the reference's ``scatter``
        (``scatter-add`` when accumulating)."""
        operand = self.value(args[0])
        indices = [None if i is None else self.value(i) for i in args[1]]
        od = np.asarray(operand.data)
        key = self._index_key(od.shape, indices)
        dest = np.arange(od.size, dtype=np.int64).reshape(od.shape)[key]
        index_srcs = self._index_operand([v for v in indices if v is not None])
        values = self._promote(args[2], od.dtype)
        accumulate = bool(_arg(args, kwargs, 3, "accumulate", False))
        return self._scatter(operand, index_srcs, values, dest, accumulate)

    def _scatter(self, operand: Value, indices: Optional[Value],
                 updates: Value, dest: np.ndarray, is_add: bool) -> Value:
        """Write ``updates`` to the flat destinations ``dest`` of
        ``operand``'s buffer; duplicate destinations keep the last writer."""
        od = np.asarray(operand.data)
        ud = np.broadcast_to(np.asarray(updates.data), dest.shape)
        uaddr = (np.broadcast_to(updates.addr, dest.shape)
                 if updates.addr is not None else None)
        base = operand if operand.addr is not None else self.m.materialize(operand)
        dflat = dest.ravel()
        dest_flat = np.full(ud.size, -1, np.int64)
        last = {d: i for i, d in enumerate(dflat.tolist())}
        for d, i in last.items():
            dest_flat[i] = d
        res = od.copy()
        if is_add:
            np.add.at(res.reshape(-1), dflat, ud.ravel())
        else:
            sel = dest_flat >= 0
            res.reshape(-1)[dest_flat[sel]] = ud.ravel()[sel]
        m = self.m
        tag = _dtype_tag(ud.dtype)
        size = _itemsize(ud.dtype)
        ua = uaddr.ravel() if uaddr is not None else None
        udf = ud.ravel()
        ia = (indices.addr.ravel() if indices is not None
              and indices.addr is not None else None)
        baddr = base.addr.ravel()
        for i in range(ud.size):
            if dest_flat[i] < 0:
                continue
            m.emit_loop_overhead()
            if ia is not None:
                m.emit_load(int(ia[i % ia.size]), "i", 4)
                m.emit_op("agen", "i", ((SRC_IMM, 0),))
            if ua is None:
                r = m.emit_op("mov", tag, ((SRC_IMM, udf[i].item()),))
            else:
                r = m.emit_load(int(ua[i]), tag, size)
            tgt = int(baddr[dest_flat[i]])
            if is_add:
                rold = m.emit_load(tgt, tag, size)
                r = m.emit_op("add", tag, ((SRC_REG, rold), (SRC_REG, r)))
            m.emit_store(tgt, r, tag, size)
        return Value(res, base.addr)

    # ------------------------------------------------ dynamic_update_slice
    def _slice_scatter(self, func, out, args, kwargs) -> Value:
        """``slice_scatter(x, u, dim, start, end)``: the reference's
        ``dynamic_update_slice``, a store per element into ``x``'s buffer."""
        operand, update = self.value(args[0]), self.value(args[1])
        dim = _arg(args, kwargs, 2, "dim", 0)
        start = _arg(args, kwargs, 3, "start")
        if _arg(args, kwargs, 5, "step", 1) != 1:
            raise NotImplementedError(f"trace VM: '{func}' takes step 1")
        od = np.asarray(operand.data)
        ud = np.asarray(update.data)
        dim %= od.ndim
        start = 0 if start is None else int(start)
        if start < 0:
            start += od.shape[dim]
        start = max(0, min(start, od.shape[dim] - ud.shape[dim]))
        sl = tuple(slice(start, start + ud.shape[dim]) if i == dim
                   else slice(0, ud.shape[i]) for i in range(od.ndim))
        res = od.copy()
        res[sl] = ud
        base = operand if operand.addr is not None else self.m.materialize(
            Value(od, None))
        # in-place update: store the update elements into the base buffer
        self._store_region(base, update, sl)
        return Value(res, base.addr)

    def _store_region(self, base: Value, update: Value, sl) -> None:
        m = self.m
        tgt_addr = base.addr[sl]
        ud = np.asarray(update.data)
        tag = _dtype_tag(ud.dtype)
        size = _itemsize(ud.dtype)
        ua = update.addr.ravel() if update.addr is not None else None
        udf = ud.ravel()
        ta = tgt_addr.ravel()
        for i in range(ud.size):
            m.emit_loop_overhead()
            if ua is None:
                r = m.emit_op("mov", tag, ((SRC_IMM, udf[i].item()),))
            else:
                r = m.emit_load(int(ua[i]), tag, size)
            m.emit_store(int(ta[i]), r, tag, size)

    # ------------------------------------------------------- control flow
    def _slice_leaf(self, x, t: int):
        """``x[t]`` of a scanned input: a view, no instructions."""
        with self.paused():
            x_t = x[t]
        v = self.value(x)
        self.bind(x_t, Value(np.asarray(v.data)[t],
                             v.addr[t] if v.addr is not None else None))
        return x_t

    def _stack(self, ys: List) -> torch.Tensor:
        """The scanned outputs stacked with their addresses (an immediate
        when any step's output is one)."""
        vals = [self.value(y) for y in ys]
        with self.paused():
            out = torch.stack(ys)
        data = np.stack([np.asarray(v.data) for v in vals])
        addr = (np.stack([v.addr for v in vals])
                if all(v.addr is not None for v in vals) else None)
        self.bind(out, Value(data, addr))
        return out


# ======================================================================
# Control flow: plain loops outside the VM, the reference's scopes inside
# ======================================================================
_RUNAWAY = 1_000_000


def scan(f: Callable, init, xs=None, length: Optional[int] = None,
         reverse: bool = False):
    """``jax.lax.scan``: ``f(carry, x) -> (carry, y)`` over the leading
    axis of ``xs`` (or ``length`` steps); returns ``(carry, stacked ys)``.

    Under the trace VM each step emits one branch before its body and ends
    an iteration of a loop scope keyed by ``f``'s code, so a re-entered
    inner loop (a new closure each outer step) reuses its slots, as the
    reference's scope keyed by the body jaxpr does."""
    vm = _active()
    leaves, spec = pytree.tree_flatten(xs)
    if length is None:
        length = int(leaves[0].shape[0])
    order = range(length - 1, -1, -1) if reverse else range(length)
    carry, ys = init, []
    if vm is not None:
        vm.m.push_loop(key=("scan", f.__code__))
    try:
        for t in order:
            if xs is None:
                x_t = None
            elif vm is not None:
                x_t = pytree.tree_unflatten([vm._slice_leaf(x, t)
                                             for x in leaves], spec)
            else:
                x_t = pytree.tree_unflatten([x[t] for x in leaves], spec)
            if vm is not None:
                vm.m.emit_branch()
            carry, y = f(carry, x_t)
            ys.append(y)
            if vm is not None:
                vm.m.next_iteration()
    finally:
        if vm is not None:
            vm.m.pop_loop()
    if reverse:
        ys = ys[::-1]
    if not ys or ys[0] is None:
        return carry, None
    y_leaves = [pytree.tree_flatten(y)[0] for y in ys]
    y_spec = pytree.tree_flatten(ys[0])[1]
    stack = vm._stack if vm is not None else torch.stack
    return carry, pytree.tree_unflatten(
        [stack([yl[i] for yl in y_leaves]) for i in range(len(y_leaves[0]))],
        y_spec)


def while_loop(cond_fun: Callable, body_fun: Callable, init_val):
    """``jax.lax.while_loop``.  Under the trace VM each test emits one
    branch, and each iteration ends a loop scope keyed by ``body_fun``'s
    code; a loop that runs past a million iterations raises."""
    vm = _active()
    val = init_val
    if vm is None:
        while bool(cond_fun(val)):
            val = body_fun(val)
        return val
    it = 0
    vm.m.push_loop(key=("while", body_fun.__code__))
    try:
        while True:
            pred = cond_fun(val)
            vm.m.emit_branch()
            if not vm.truth(pred):
                break
            val = body_fun(val)
            vm.m.next_iteration()
            it += 1
            if it > _RUNAWAY:
                raise RuntimeError("while loop runaway in trace VM")
    finally:
        vm.m.pop_loop()
    return val


def cond(pred, true_fun: Callable, false_fun: Callable, *operands):
    """``jax.lax.cond``: the predicate is converted to an int32 branch
    index (a mov when it lives in memory), one branch is emitted, and the
    taken branch runs on ``operands``."""
    vm = _active()
    if vm is None:
        return (true_fun if bool(pred) else false_fun)(*operands)
    if isinstance(pred, torch.Tensor):
        pred = torch.ops.aten._to_copy.default(pred, dtype=torch.int32)
    vm.m.emit_branch()
    return (true_fun if vm.truth(pred) else false_fun)(*operands)


# ======================================================================
# Public API
# ======================================================================
@dataclasses.dataclass
class StructuralTrace:
    """Geometry-independent half of a traced program: the structural
    columns plus the program's concrete outputs.  One of these exists per
    workload; :func:`attach_cache_results` replays its memory stream
    through a cache hierarchy to produce the per-geometry
    :class:`TraceResult`."""
    columns: ColumnarTrace
    outputs: List[torch.Tensor]

    @property
    def n_instructions(self) -> int:
        return len(self.columns)


class TraceResult:
    """One traced (program, cache geometry) pair: the columnar CIQ with
    memory-response columns filled, the hierarchy (for its counters), and
    the program outputs."""

    __slots__ = ("trace", "cache", "outputs", "structural")

    def __init__(self, trace: ColumnarTrace, cache: CacheHierarchy,
                 outputs: List[torch.Tensor],
                 structural: Optional[StructuralTrace] = None):
        self.trace = trace
        self.cache = cache
        self.outputs = outputs
        self.structural = structural

    @property
    def rut(self) -> Dict[int, List[int]]:
        return self.trace.rut

    @property
    def iht(self) -> Dict[int, List[Tuple[int, int]]]:
        return self.trace.iht

    @property
    def n_instructions(self) -> int:
        return len(self.trace)

    def mem_accesses(self) -> int:
        return self.trace.mem_accesses()


def run_program(vm: TraceInterpreter, fn: Callable, *args) -> List[Value]:
    """Run ``fn(*args)`` eagerly under ``vm``; returns the Values of its
    output leaves.

    ``args`` (tensors, any pytree) are the program's memory-resident
    inputs, stored first in argument order; then the arrays ``fn`` closes
    over, listed in ``fn.consts`` (a 0-d one is an immediate), as the
    reference stores a jaxpr's constants after its inputs.  Every pass of
    the VM over a program (:func:`trace_structural`, the sampling skim and
    windowed passes) binds its inputs here, so all of them walk one
    virtual instruction stream."""
    machine = vm.m
    leaves, spec = pytree.tree_flatten(args)
    leaves = [a.detach().cpu() if isinstance(a, torch.Tensor)
              else torch.as_tensor(a) for a in leaves]
    for a in leaves:
        vm.bind(a, machine.store_const(_host(a)))
    for c in getattr(fn, "consts", ()):
        arr = _host(c)
        vm.bind(c, Value(arr, None) if arr.ndim == 0
                else machine.store_const(arr))
    with vm:
        outs = fn(*pytree.tree_unflatten(leaves, spec))
    return [vm.value(o) for o in pytree.tree_leaves(outs)]


def trace_structural(fn: Callable, *args, n_regs: int = 24,
                     limits: TraceLimits = TraceLimits(),
                     device="cuda") -> StructuralTrace:
    """Lower ``fn(*args)`` to the structural instruction columns, on
    ``device`` (no cache model involved -- the stream is identical under
    every geometry).

    Inputs and constants are stored as :func:`run_program` says.  The
    program runs on the host; only the finished columns move to
    ``device``."""
    dev = resolve_device(device)
    machine = Machine(n_regs=n_regs, limits=limits)
    outs = run_program(TraceInterpreter(machine), fn, *args)
    return StructuralTrace(
        machine.b.finish(machine.n_regs, device=dev),
        [torch.from_numpy(np.array(v.data)) for v in outs])


def attach_cache_results(st: StructuralTrace,
                         cache_levels: Tuple[CacheConfig, ...] = (L1_32K,
                                                                  L2_256K),
                         device="cuda") -> TraceResult:
    """Replay the structural trace's memory stream through one cache
    hierarchy, producing its level/hit/bank/MSHR columns."""
    return attach_cache_results_batch(st, [cache_levels], device=device)[0]


def attach_cache_results_batch(st: StructuralTrace,
                               geometries: Sequence[Tuple[CacheConfig, ...]],
                               device="cuda") -> List[TraceResult]:
    """Replay one structural trace under many cache geometries on
    ``device``.

    The structural columns are shared; each geometry only gets its own
    level/hit/bank/MSHR columns.  On ``cuda`` every geometry of one depth
    comes out of one launch of the replay kernel; on ``cpu`` the plain
    :meth:`CacheHierarchy.replay` runs per geometry.  Either way each
    result's hierarchy carries the replay's counters with cold sets, like
    the reference's store-rehydration path."""
    from repro_torch.core.accel.replay import replay_columns_batch

    ct = st.columns.to(resolve_device(device))
    mem_idx = torch.nonzero(ct.mem_mask).flatten()
    addrs = ct.addr[mem_idx]
    is_writes = ct.op[mem_idx] == OP_STORE
    batched = replay_columns_batch(addrs, is_writes, list(geometries))
    out = []
    for (lvl, hit, bank, mshr, counters), cache_levels in zip(batched,
                                                              geometries):
        hier = CacheHierarchy(cache_levels)
        hier.restore_counters(counters)
        level_col = torch.zeros(ct.n, dtype=torch.int8, device=ct.device)
        hit_col = torch.full((ct.n,), -1, dtype=torch.int8, device=ct.device)
        bank_col = torch.full((ct.n,), -1, dtype=torch.int16,
                              device=ct.device)
        mshr_col = torch.zeros(ct.n, dtype=torch.bool, device=ct.device)
        level_col[mem_idx] = lvl
        hit_col[mem_idx] = hit
        bank_col[mem_idx] = bank
        mshr_col[mem_idx] = mshr
        out.append(TraceResult(ct.with_mem_results(level_col, hit_col,
                                                   bank_col, mshr_col),
                               hier, st.outputs, structural=st))
    return out


def trace_program(fn: Callable, *args,
                  cache_levels: Tuple[CacheConfig, ...] = (L1_32K, L2_256K),
                  n_regs: int = 24, limits: TraceLimits = TraceLimits(),
                  device="cuda") -> TraceResult:
    """Run ``fn(*args)`` on the trace VM; returns the CIQ with one cache
    geometry's memory-response columns.

    ``args`` are treated as memory-resident program inputs (like benchmark
    data loaded before the region of interest); literals and iota lower to
    immediates."""
    return attach_cache_results(
        trace_structural(fn, *args, n_regs=n_regs, limits=limits,
                         device=device),
        cache_levels, device=device)
