"""Pseudo-RISC ISA + I-state records (paper Table I).

The paper traces committed ARM instructions out of GEM5; we lower jaxpr
equations to an equivalent scalar RISC stream (``core/trace.py``).  Each
committed instruction is one :class:`Inst` — the "I-state" of Table I:

  sequence index        -> ``seq``
  mnemonic code         -> ``op`` (+ ``dtype`` tag)
  execution logic       -> ``unit`` (triggered functional unit)
  request from master   -> ``addr`` (address of a load/store request)
  memory access         -> ``level`` (cache level that served it), ``bank``
  response from slave   -> ``hit`` / ``mshr`` status

Registers are a finite file per class (int / float); ``srcs`` entries are
``(SRC_REG, reg_id)`` or ``(SRC_IMM, value)`` — immediates are the paper's
Fig. 4(b) variant.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

# ----------------------------------------------------------------- source tags
SRC_REG = 0
SRC_IMM = 1

# ------------------------------------------------------------ functional units
# (PipeProbe's "triggered functional unit" vocabulary.)
U_INT_ALU = "IntAlu"
U_INT_MUL = "IntMult"
U_INT_DIV = "IntDiv"
U_FP_ALU = "FloatAdd"
U_FP_MUL = "FloatMult"
U_FP_DIV = "FloatDiv"
U_FP_SPECIAL = "FloatSqrt"       # exp/log/tanh/rsqrt — the special-function unit
U_MEM_RD = "MemRead"
U_MEM_WR = "MemWrite"
U_BRANCH = "Branch"
U_SIMD = "SimdAlu"

_FLOAT_OPS_UNITS = {
    "add": U_FP_ALU, "sub": U_FP_ALU, "max": U_FP_ALU, "min": U_FP_ALU,
    "cmp": U_FP_ALU, "abs": U_FP_ALU, "neg": U_FP_ALU, "sel": U_FP_ALU,
    "mul": U_FP_MUL, "div": U_FP_DIV,
    "exp": U_FP_SPECIAL, "log": U_FP_SPECIAL, "tanh": U_FP_SPECIAL,
    "sqrt": U_FP_SPECIAL, "rsqrt": U_FP_SPECIAL, "sigmoid": U_FP_SPECIAL,
    "pow": U_FP_SPECIAL, "floor": U_FP_ALU, "round": U_FP_ALU, "sign": U_FP_ALU,
}
_INT_OPS_UNITS = {
    "add": U_INT_ALU, "sub": U_INT_ALU, "max": U_INT_ALU, "min": U_INT_ALU,
    "and": U_INT_ALU, "or": U_INT_ALU, "xor": U_INT_ALU, "not": U_INT_ALU,
    "shl": U_INT_ALU, "shr": U_INT_ALU, "cmp": U_INT_ALU, "sel": U_INT_ALU,
    "abs": U_INT_ALU, "neg": U_INT_ALU, "mov": U_INT_ALU, "sign": U_INT_ALU,
    "mul": U_INT_MUL, "div": U_INT_DIV, "rem": U_INT_DIV,
    "floor": U_INT_ALU, "round": U_INT_ALU,
    "agen": U_INT_ALU,            # loop induction / address generation —
                                  # never CiM-offloadable (host-only)
}


def unit_for(op: str, is_float: bool) -> str:
    if op == "load":
        return U_MEM_RD
    if op == "store":
        return U_MEM_WR
    table = _FLOAT_OPS_UNITS if is_float else _INT_OPS_UNITS
    return table.get(op, U_FP_ALU if is_float else U_INT_ALU)


# -------------------------------------------------------------- CiM op presets
# Table III's realized op set is {OR, AND, XOR, ADDW32}; [23] (STT-CiM)
# additionally supports SUB and CMP (-> max/min via compare-select).  We keep
# three presets; experiments use CIM_SET_STT unless stated otherwise.
CIM_SET_LOGIC = frozenset({"and", "or", "xor"})
CIM_SET_STT = frozenset({"and", "or", "xor", "add", "sub", "max", "min", "cmp"})
CIM_SET_FULL = CIM_SET_STT | frozenset({"mul"})   # bit-serial in-memory multiply

# Map an offloaded op onto the priced CiM operation class of Table III.
CIM_OP_CLASS = {
    "or": "CiM-OR", "and": "CiM-AND", "xor": "CiM-XOR", "not": "CiM-OR",
    "add": "CiM-ADD", "sub": "CiM-ADD",
    "max": "CiM-XOR", "min": "CiM-XOR", "cmp": "CiM-XOR",  # compare via SA tags
    "mul": "CiM-MUL",
}


# --------------------------------------------------- integer vocabularies
# The columnar trace core (cimbench.ref.columnar) stores one small integer per
# I-state field instead of Python strings; these tuples are the shared,
# stable decode tables.  Codes index the tuples, so ``OPS[code]`` /
# ``OP_CODE[name]`` round-trip.  Order is append-only: extending a
# vocabulary must add at the END (persisted .npz artifacts embed the codes;
# reordering is a TRACE_VM_VERSION bump).
OPS = (
    "load", "store", "branch", "agen", "mov",
    "add", "sub", "mul", "div", "rem", "pow",
    "max", "min", "cmp", "sel",
    "and", "or", "xor", "not", "shl", "shr",
    "abs", "neg", "sign", "floor", "round",
    "exp", "log", "tanh", "sqrt", "rsqrt", "sigmoid",
)
OP_CODE = {name: i for i, name in enumerate(OPS)}
OP_LOAD = OP_CODE["load"]
OP_STORE = OP_CODE["store"]
OP_MOV = OP_CODE["mov"]

UNITS = (U_INT_ALU, U_INT_MUL, U_INT_DIV, U_FP_ALU, U_FP_MUL, U_FP_DIV,
         U_FP_SPECIAL, U_MEM_RD, U_MEM_WR, U_BRANCH, U_SIMD)
UNIT_CODE = {name: i for i, name in enumerate(UNITS)}

# cache level served an access (0 = not a memory instruction)
LEVELS = (None, "L1", "L2", "MEM")
LEVEL_CODE = {name: i for i, name in enumerate(LEVELS) if name}
LEVEL_NONE, LEVEL_L1, LEVEL_L2, LEVEL_MEM = 0, 1, 2, 3

DTYPE_TAGS = ("i", "f")
DTYPE_CODE = {"i": 0, "f": 1}

# immediate-value kinds (float64 storage round-trips through these)
IMM_INT, IMM_FLOAT, IMM_BOOL = 0, 1, 2


class Inst:
    """One committed instruction (I-state record, Table I)."""

    __slots__ = ("seq", "op", "unit", "dtype", "dst", "srcs", "addr", "size",
                 "level", "hit", "bank", "mshr")

    def __init__(self, seq: int, op: str, unit: str, dtype: str,
                 dst: Optional[int], srcs: Tuple,
                 addr: Optional[int] = None, size: int = 4):
        self.seq = seq
        self.op = op
        self.unit = unit
        self.dtype = dtype
        self.dst = dst                  # destination register id (None: store)
        self.srcs = srcs                # ((SRC_REG, r) | (SRC_IMM, v), ...)
        self.addr = addr                # memory address (load/store only)
        self.size = size                # access bytes
        # Filled by the cache model (AccessProbe / response-from-slave):
        self.level = None               # "L1" | "L2" | "MEM"
        self.hit = None                 # bool: hit at first-level lookup
        self.bank = None                # bank id at `level`
        self.mshr = False               # miss merged into an in-flight MSHR

    # --- serialization hooks (the analysis store persists whole traces) -------
    # Default __slots__ pickling emits a per-instance dict of slot names;
    # a positional tuple is ~2x smaller and faster over 10^4-10^5 records.
    def __getstate__(self) -> Tuple:
        return (self.seq, self.op, self.unit, self.dtype, self.dst,
                self.srcs, self.addr, self.size, self.level, self.hit,
                self.bank, self.mshr)

    def __setstate__(self, state: Tuple) -> None:
        (self.seq, self.op, self.unit, self.dtype, self.dst, self.srcs,
         self.addr, self.size, self.level, self.hit, self.bank,
         self.mshr) = state

    @property
    def is_load(self) -> bool:
        return self.op == "load"

    @property
    def is_store(self) -> bool:
        return self.op == "store"

    @property
    def is_mem(self) -> bool:
        return self.op in ("load", "store")

    @property
    def is_float(self) -> bool:
        return self.dtype == "f"

    def __repr__(self) -> str:  # debugging aid, mirrors Fig. 6's queue rows
        srcs = ",".join((f"r{v}" if t == SRC_REG else f"#{v!r}") for t, v in self.srcs)
        mem = f" @{self.addr:#x}[{self.level or '?'}]" if self.is_mem else ""
        dst = f"r{self.dst} <- " if self.dst is not None else ""
        return f"<{self.seq}: {dst}{self.op}.{self.dtype} {srcs}{mem}>"


Trace = List[Inst]                       # the committed instruction queue (CIQ)
