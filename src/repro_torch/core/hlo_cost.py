"""Static cost of a recorded ATen graph (the port's counterpart of
``repro/core/hlo_cost.py``'s ``analyze_hlo`` in the accelerator-mode
backend and the sharded dry run), and ``analyze_hlo`` itself over HLO text.

The reference parses post-SPMD HLO text and multiplies loop bodies by
their trip counts.  The port's graph is recorded eagerly, so Python loops
are already unrolled and every op appears as often as it ran:

  * ``flops`` — 2·M·N·K for every matrix product of the graph (``mm``,
    ``addmm``: M×K by K×N; ``bmm``, ``baddbmm``: a batch of them; the
    bias of ``addmm``/``baddbmm`` is not counted).  No arch of the
    registry has a convolution, so none is counted;
  * ``bytes`` — the tensor bytes every non-view op reads and writes (the
    reference's ``hlo_bytes``, reported only);
  * ``collectives`` — per HLO opcode (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``) the bytes of each collective's
    local *output*, as ``collective_bytes`` counts a result shape, with
    ``<kind>_count``; empty for a graph of one device.

:func:`analyze_hlo` is the reference's trip-count-aware parser of
post-SPMD HLO text, line for line.  The port has no HLO, so it prices no
step here; it serves HLO text from elsewhere and the tests that hold it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hlo import COLLECTIVES, Graph, _COLL_RE, shape_bytes

_MM = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


@dataclasses.dataclass
class HloCost:
    flops: float
    bytes: float
    collectives: Dict[str, float]
    dot_profile: List[Tuple[float, str]] = dataclasses.field(default_factory=list)

    @property
    def collective_total(self) -> float:
        return sum(v for k, v in self.collectives.items()
                   if not k.endswith("_count"))

    def top_dots(self, n: int = 12) -> List[Tuple[float, str]]:
        """The dominant matmuls (effective FLOPs = per-execution x trips)."""
        return sorted(self.dot_profile, reverse=True)[:n]


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def eqn_flops(graph: Graph, eqn) -> float:
    """FLOPs of one recorded op (0 for anything but a matrix product)."""
    if eqn.aten.rsplit(".", 1)[0] not in _MM:
        return 0.0
    # the two matrix operands are the last two tensor arguments
    a, b = (graph.shapes[v] for v in eqn.invars[-2:])
    return 2.0 * _prod(a) * b[-1]


def collective_kind(prim: str) -> Optional[str]:
    """The HLO opcode of a recorded collective (in place or not), else
    ``None``."""
    return COLLECTIVES.get(prim.rstrip("_")) if "." in prim else None


def analyze_graph(graph: Graph) -> HloCost:
    """FLOPs, byte footprint and collective bytes of a recorded graph."""
    flops = 0.0
    nbytes = 0
    coll: Dict[str, float] = {}
    for eqn in graph.eqns:
        flops += eqn_flops(graph, eqn)
        if eqn.klass != "view":
            nbytes += sum(graph.nbytes(v) for v in eqn.invars + eqn.outvars)
        kind = collective_kind(eqn.prim)
        if kind is not None:
            out = sum(graph.nbytes(v) for v in eqn.outvars)
            coll[kind] = coll.get(kind, 0.0) + out
            coll[kind + "_count"] = coll.get(kind + "_count", 0.0) + 1
    return HloCost(flops=flops, bytes=float(nbytes), collectives=coll)


# ======================================================================
# post-SPMD HLO text (the reference's analyze_hlo)
# ======================================================================
_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->")
_PARAM_RE = re.compile(
    r"([\w.\-]+)\s*:\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[\d,]*\](?:\{[^}]*\})?))")
_INST_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^)]*\))|\S+)\s+([\w\-]+)\(")
_DOT_ARGS_RE = re.compile(r"\bdot\(([^)]*)\)")
_LHS_C_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_LHS_B_RE = re.compile(r"lhs_batch_dims=\{([\d,]*)\}")
_TRIP_RE = re.compile(r'known_trip_count["\s:{]+n["\s:]+\"?(\d+)')
_TRIP_RE2 = re.compile(r"trip_count=(\d+)")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_APPLY_RE = re.compile(r"to_apply=%?([\w.\-]+)")
_SHAPE_DIMS_RE = re.compile(r"[a-z0-9]+\[([\d,]*)\]")
_REF_RE = re.compile(r"%([\w.\-]+)")


def _dims(type_str: str) -> List[int]:
    m = _SHAPE_DIMS_RE.search(type_str)
    if not m or not m.group(1):
        return []
    return [int(d) for d in m.group(1).split(",")]


@dataclasses.dataclass
class _Comp:
    name: str
    shapes: Dict[str, str]                       # instr/param name -> type str
    local_flops: float = 0.0
    local_bytes: float = 0.0
    local_coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    # (child computation name, multiplier)
    children: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    is_fusion_like: bool = False                 # bytes counted by caller
    dots: List[Tuple[float, str]] = dataclasses.field(default_factory=list)


def _parse_computations(text: str) -> Tuple[Dict[str, _Comp], Optional[str]]:
    comps: Dict[str, _Comp] = {}
    cur: Optional[_Comp] = None
    entry: Optional[str] = None
    for raw in text.splitlines():
        if cur is None:
            m = _HDR_RE.match(raw)
            if m and raw.rstrip().endswith("{"):
                cur = _Comp(m.group(1), {})
                if raw.lstrip().startswith("ENTRY"):
                    entry = cur.name
                for pname, ptype in _PARAM_RE.findall(m.group(2)):
                    cur.shapes[pname] = ptype
            continue
        if raw.startswith("}"):
            comps[cur.name] = cur
            cur = None
            continue
        mi = _INST_RE.match(raw)
        if not mi:
            continue
        iname, itype, opcode = mi.groups()
        cur.shapes[iname] = itype

        if opcode == "dot":
            out_elems = 1
            for d in _dims(itype):
                out_elems *= d
            k = 1
            margs = _DOT_ARGS_RE.search(raw)
            mc = _LHS_C_RE.search(raw)
            if margs and mc and mc.group(1):
                refs = _REF_RE.findall(margs.group(1))
                if refs:
                    lhs_shape = _dims(cur.shapes.get(refs[0], ""))
                    for ci in mc.group(1).split(","):
                        ci = int(ci)
                        if ci < len(lhs_shape):
                            k *= lhs_shape[ci]
            cur.local_flops += 2.0 * out_elems * k
            meta = raw.split("metadata=")
            tag = meta[1][:120] if len(meta) > 1 else raw.strip()[:120]
            cur.dots.append((2.0 * out_elems * k, f"{itype} {tag}"))

        mcoll = _COLL_RE.search(raw)
        if mcoll:
            kind = mcoll.group(3)
            nb = shape_bytes(mcoll.group(2))
            cur.local_coll[kind] = cur.local_coll.get(kind, 0.0) + nb
            cur.local_coll[kind + "_count"] = \
                cur.local_coll.get(kind + "_count", 0.0) + 1

        # ---- call edges -------------------------------------------------
        if opcode == "while":
            trip = 1.0
            mt = _TRIP_RE.search(raw) or _TRIP_RE2.search(raw)
            if mt:
                trip = float(mt.group(1))
            mb = _BODY_RE.search(raw)
            if mb:
                cur.children.append((mb.group(1), trip))
            mc2 = _COND_RE.search(raw)
            if mc2:
                cur.children.append((mc2.group(1), trip + 1))
        elif opcode == "fusion":
            mf = _CALLS_RE.search(raw)
            if mf:
                cur.children.append((mf.group(1), 1.0))
        elif opcode == "conditional":
            mb2 = _BRANCHES_RE.search(raw)
            if mb2:
                for ref in _REF_RE.findall(mb2.group(1)):
                    cur.children.append((ref, 1.0))
        elif opcode in ("call", "custom-call", "async-start"):
            mf = _APPLY_RE.search(raw) or _CALLS_RE.search(raw)
            if mf:
                cur.children.append((mf.group(1), 1.0))

        # ---- byte footprint (top-level ops only; operands + result) ------
        if opcode not in ("parameter", "constant", "tuple", "get-tuple-element",
                          "bitcast", "while", "conditional"):
            b = shape_bytes(itype)
            for ref in _REF_RE.findall(raw.split("metadata")[0])[1:6]:
                if ref in cur.shapes:
                    b += shape_bytes(cur.shapes[ref])
            cur.local_bytes += b
    if cur is not None:
        comps[cur.name] = cur
    return comps, entry


def analyze_hlo(text: str, details: bool = False) -> HloCost:
    """Trip-count-aware FLOPs, bytes and collective bytes of a post-SPMD
    HLO module: while bodies x their trip counts, fusions, conditionals
    and calls, as the reference accumulates them."""
    comps, entry = _parse_computations(text)
    memo: Dict[str, Tuple] = {}

    def total(name: str, stack=()) -> Tuple:
        if name in memo:
            return memo[name]
        if name not in comps or name in stack:
            return (0.0, 0.0, {}, [])
        c = comps[name]
        f, b = c.local_flops, c.local_bytes
        coll = dict(c.local_coll)
        dots = list(c.dots) if details else []
        for child, mult in c.children:
            cf, cb, cc, cd = total(child, stack + (name,))
            f += mult * cf
            # fusion-internal temporaries excluded from bytes
            if not child.startswith(("wrapped_", "fused_")):
                b += mult * cb
            for k, v in cc.items():
                coll[k] = coll.get(k, 0.0) + mult * v
            if details:
                dots.extend((mult * df, dl) for df, dl in cd)
        memo[name] = (f, b, coll, dots)
        return memo[name]

    roots = [entry] if entry else list(comps)
    f, b, coll, dots = total(roots[0]) if roots else (0.0, 0.0, {}, [])
    return HloCost(flops=f, bytes=b, collectives=coll, dot_profile=dots)
