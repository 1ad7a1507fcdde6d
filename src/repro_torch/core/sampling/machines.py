"""Sampling modes of the trace VM: the structural skim and windowed traces.

Twin of ``repro/core/sampling/machines.py``.  Both run the ordinary
:class:`~repro_torch.core.trace.TraceInterpreter` program walk (the
program runs eagerly under the dispatch mode, its inputs bound by
:func:`~repro_torch.core.trace.run_program`, so control flow, loop-scoped
buffer reuse, and concrete values are exactly the exact-mode ones) but
swap the machine underneath:

:class:`SkimMachine`
    Never emits an instruction.  Every array-shaped handler announces the
    exact number of *virtual* instructions its exact-mode emission loop
    would commit (the no-elision count — elision depends on register-file
    state that the skim deliberately does not model) and the machine
    consumes the whole span in O(1), accumulating per-interval structural
    feature rows (op-mix + dependency-depth histograms).  This is the
    ≥10x-cheaper feature pass that phase clustering runs on.

:class:`WindowedMachine`
    Emits only inside the sampled windows.  Spans that miss every window
    are skipped in O(1); spans that overlap one run the real per-element
    emission loop, gated per instruction.  Each window starts *cold*
    (register file cleared at entry — the standard sampled-simulation
    approximation), and the builder row range of every window is recorded
    in ``marks`` so the finished columnar trace can be sliced back into
    per-window traces.

The two machines share one virtual-instruction coordinate system (the
position in the no-elision instruction stream), which is what makes skim
intervals and traced windows line up.  :class:`SamplingInterpreter`'s
per-handler count formulas are asserted against the actual emission
whenever a span is emitted — formula drift fails loudly, not silently.

The helpers with a count formula are the ones every ATen handler of the
port's VM lowers through (elementwise, reductions, argmax/argmin, matmul,
the copy family, gathers and region stores; sort, cumsum, cat and pad
among them).  The rest -- scatter (``index_put``) and ``materialize`` --
take the gated per-emit path, as the reference's scatter does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.columnar import resolve_device
from repro_torch.core.isa import (OPS, OP_CODE, OP_LOAD, OP_STORE, SRC_IMM,
                                  SRC_REG)
from repro_torch.core.trace import (Machine, StructuralTrace,
                                    TraceInterpreter, TraceLimits, Value,
                                    _dtype_tag, _itemsize, run_program)

_OP_AGEN = OP_CODE["agen"]
_OP_BRANCH = OP_CODE["branch"]
_OP_MOV = OP_CODE["mov"]
_OP_CMP = OP_CODE["cmp"]
_OP_SEL = OP_CODE["sel"]
_OP_MUL = OP_CODE["mul"]
_OP_ADD = OP_CODE["add"]

#: dependency-depth histogram buckets (log2 of the accumulation chain
#: length, clipped) appended after the per-opcode columns
N_DEPTH = 8
N_FEATURES = len(OPS) + N_DEPTH


def _depth_col(depth: int) -> int:
    d = max(1, int(depth))
    return len(OPS) + min(N_DEPTH - 1, d.bit_length() - 1)


class _SamplingMachine(Machine):
    """Shared virtual-counter plumbing of the two sampling machines."""

    def __init__(self, n_regs: int = 24,
                 limits: TraceLimits = TraceLimits()):
        super().__init__(n_regs=n_regs, limits=limits, loop_overhead=True)
        self.virtual = 0          # position in the no-elision stream

    def span_total(self, k_ov: int, rows: int) -> int:
        """Virtual instructions of a span that emits ``rows`` payload rows
        plus ``k_ov`` loop-overhead agens (amortized branches included)."""
        c0 = self._ov_count
        return rows + k_ov + (c0 + k_ov) // self.UNROLL - c0 // self.UNROLL

    def take_bulk(self, total: int, k_ov: int,
                  ops: Tuple[Tuple[int, int], ...], loads: int, stores: int,
                  depth: int, depth_n: int) -> bool:
        """Offer a whole handler span; True = consumed in O(1), False =
        the caller must run the real emission loop."""
        raise NotImplementedError

    def span_inside(self, total: int) -> bool:
        """True if the next ``total`` virtual slots all lie inside an
        emitting window (the exact per-element loop is then both correct
        and cheap — every gate check passes)."""
        return False


# ======================================================================
# Skim
# ======================================================================
class SkimMachine(_SamplingMachine):
    """Feature-columns-only interpretation (no instruction is ever built)."""

    def __init__(self, interval: int, n_regs: int = 24):
        # virtual length is unbounded by the builder: lift the trace limit
        super().__init__(n_regs=n_regs,
                         limits=TraceLimits(max_instructions=1 << 62))
        self.interval = int(interval)
        self._feat = np.zeros((256, N_FEATURES))

    # ------------------------------------------------------------ features
    def _row(self, i: int) -> np.ndarray:
        f = self._feat
        if i >= f.shape[0]:
            grown = np.zeros((max(i + 1, f.shape[0] * 2), N_FEATURES))
            grown[:f.shape[0]] = f
            self._feat = f = grown
        return f[i]

    def features(self) -> np.ndarray:
        """Per-interval feature matrix ``[n_intervals, N_FEATURES]``."""
        n = max(1, -(-self.virtual // self.interval))
        self._row(n - 1)                         # ensure capacity
        return self._feat[:n].copy()

    def _tick(self, col: int) -> None:
        v = self.virtual
        self.virtual = v + 1
        self._row(v // self.interval)[col] += 1

    # ----------------------------------------------------------- bulk path
    def take_bulk(self, total, k_ov, ops, loads, stores, depth, depth_n):
        v0 = self.virtual
        self.virtual = v0 + total
        self._ov_count += k_ov
        if total <= 0:
            return True
        opsum = 0
        pairs = []
        for code, c in ops:
            if c:
                pairs.append((code, c))
                opsum += c
        if loads:
            pairs.append((OP_LOAD, loads))
        if stores:
            pairs.append((OP_STORE, stores))
        if k_ov:
            pairs.append((_OP_AGEN, k_ov))
        nbr = total - k_ov - loads - stores - opsum
        if nbr:
            pairs.append((_OP_BRANCH, nbr))
        iv = self.interval
        i0, i1 = v0 // iv, (v0 + total - 1) // iv
        if i0 == i1:
            row = self._row(i0)
            for col, c in pairs:
                row[col] += c
            if depth_n:
                row[_depth_col(depth)] += depth_n
            return True
        dcol = _depth_col(depth)
        for i in range(i0, i1 + 1):
            frac = (min(v0 + total, (i + 1) * iv) - max(v0, i * iv)) / total
            row = self._row(i)
            for col, c in pairs:
                row[col] += c * frac
            if depth_n:
                row[dcol] += depth_n * frac
        return True

    # ----------------------------------------------- per-emit fallback path
    # Handlers without a bulk formula (scatter, materialize) still run their
    # exact emission loops; these overrides keep the virtual counter and the
    # feature rows in step without ever touching the columnar builder.
    def emit_load(self, addr, tag, size):
        self._tick(OP_LOAD)
        return 0

    def emit_op(self, op, tag, srcs, dst=None):
        self._tick(OP_CODE[op])
        return 0 if dst is None else dst

    def emit_store(self, addr, reg, tag, size):
        self._tick(OP_STORE)

    def emit_branch(self):
        self._tick(_OP_BRANCH)

    def emit_loop_overhead(self):
        self._tick(_OP_AGEN)
        self._ov_count += 1
        if self._ov_count % self.UNROLL == 0:
            self.emit_branch()

    def emit_scalar(self, op, tag, invals, out_addr, osize):
        self.emit_loop_overhead()
        for v in invals:
            if v.addr is not None:
                self._tick(OP_LOAD)
        self._tick(OP_CODE[op])
        self._tick(OP_STORE)


# ======================================================================
# Windowed trace
# ======================================================================
class WindowedMachine(_SamplingMachine):
    """Emit only inside sampled windows of the virtual stream.

    ``bounds`` is the flattened, sorted window-boundary list
    ``[lo0, hi0, lo1, hi1, ...]`` (half-open, non-overlapping; adjacent
    windows may share a boundary — each crossing toggles).  ``marks``
    records ``[window_index, first_row, end_row]`` per entered window over
    the *builder* rows, so the finished trace slices back per window.
    """

    def __init__(self, bounds: Sequence[int], n_regs: int = 24,
                 limits: TraceLimits = TraceLimits()):
        super().__init__(n_regs=n_regs, limits=limits)
        self._bounds = list(map(int, bounds))
        self._bounds_arr = np.asarray(self._bounds, np.int64)
        self._bptr = 0
        self._inside = False
        self.marks: List[List[int]] = []

    # ----------------------------------------------------------- stepping
    def _cross(self, bp: int) -> None:
        if bp & 1:                           # crossed a hi: exiting
            self._inside = False
            self.marks[-1][2] = self.b.n
        else:                                # crossed a lo: entering
            self._inside = True
            lo = self._bounds[bp]
            if lo > 0 and (bp == 0 or self._bounds[bp - 1] < lo):
                # Entry after a *gap*: every register holds an unknown
                # value from the skipped stretch.  Poison bindings
                # (addresses no load ever asks for) keep the allocator in
                # its steady state — one LRU eviction per allocation —
                # instead of granting n_regs eviction-free allocations,
                # which would let the window's own bindings survive longer
                # than in the exact machine and elide loads the exact
                # trace emits.  Adjacent windows (shared boundary — e.g. a
                # warmup window flowing into its measured window) keep the
                # running state, and a window at virtual 0 is genuinely
                # cold, so the full-window trace stays byte-identical to
                # exact mode.
                self._reg_of_addr.clear()
                self._addr_of_reg.clear()
                self._free_regs = []
                self._rr = -1
                for r in range(self.n_regs):
                    self._reg_of_addr[-r - 1] = r
                    self._addr_of_reg[r] = -r - 1
            self.marks.append([bp // 2, self.b.n, -1])

    def _step(self) -> bool:
        """Advance the virtual counter one slot; True if it lies inside a
        window (crossing a boundary toggles, entering resets the register
        file — sampled windows start cold)."""
        v = self.virtual
        self.virtual = v + 1
        bounds = self._bounds
        bp = self._bptr
        while bp < len(bounds) and v >= bounds[bp]:
            self._cross(bp)
            bp += 1
        self._bptr = bp
        return self._inside

    def _sync(self) -> None:
        """Process boundary crossings a bulk jump passed over.  Jumps only
        ever span inactive stretches (no emission between the crossing and
        now), so the deferred mark row ``b.n`` is the one the crossing
        would have recorded."""
        v = self.virtual
        bounds = self._bounds
        bp = self._bptr
        while bp < len(bounds) and v >= bounds[bp]:
            self._cross(bp)
            bp += 1
        self._bptr = bp

    def finish_marks(self) -> List[Tuple[int, int, int]]:
        self._sync()
        if self.marks and self.marks[-1][2] == -1:
            self.marks[-1][2] = self.b.n
        return [tuple(m) for m in self.marks]

    # ----------------------------------------------------------- bulk path
    def take_bulk(self, total, k_ov, ops, loads, stores, depth, depth_n):
        self._sync()
        if self._inside:
            return False
        v = self.virtual
        bp = self._bptr
        if bp < len(self._bounds) and v + total > self._bounds[bp]:
            return False                     # span reaches the next window
        self.virtual = v + total
        self._ov_count += k_ov
        return True

    def span_inside(self, total):
        self._sync()
        return (self._inside and self._bptr < len(self._bounds)
                and self.virtual + total <= self._bounds[self._bptr])

    # -------------------------------------------------------- gated emits
    def emit_load(self, addr, tag, size):
        if self._step():
            return super().emit_load(addr, tag, size)
        return 0

    def emit_op(self, op, tag, srcs, dst=None):
        if self._step():
            return super().emit_op(op, tag, srcs, dst=dst)
        return 0 if dst is None else dst

    def emit_store(self, addr, reg, tag, size):
        if self._step():
            super().emit_store(addr, reg, tag, size)

    def emit_branch(self):
        if self._step():
            super().emit_branch()

    def emit_loop_overhead(self):
        if self._step():
            self.b.add(*self._ov_args)
            self._check_limit()
        self._ov_count += 1
        if self._ov_count % self.UNROLL == 0:
            self.emit_branch()

    def emit_scalar(self, op, tag, invals, out_addr, osize):
        # the exact machine inlines this sequence for speed; the windowed
        # machine re-expands it so every slot goes through the gate
        self.emit_loop_overhead()
        srcs = []
        for v in invals:
            if v.addr is None:
                srcs.append((SRC_IMM, v.data.item()))
            else:
                r = self.emit_load(v.addr.item(),
                                   _dtype_tag(v.data.dtype),
                                   _itemsize(v.data.dtype))
                srcs.append((SRC_REG, r))
        rd = self.emit_op(op, tag, srcs)
        self.emit_store(out_addr, rd, tag, osize)


def _active(bounds: np.ndarray, s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """Which of the cells ``[s[i], e[i])`` overlap any window of the
    flattened boundary list (vectorized over all cells of a span)."""
    if len(bounds) == 0:
        return np.zeros(len(s), bool)
    p = np.searchsorted(bounds, s, side="right")
    inside = (p & 1) == 1
    nxt = bounds[np.minimum(p, len(bounds) - 1)]
    return inside | ((p < len(bounds)) & (nxt < e))


_noop = lambda *a: None  # noqa: E731


# ======================================================================
# Counting interpreter
# ======================================================================
class SamplingInterpreter(TraceInterpreter):
    """TraceInterpreter whose array handlers announce exact no-elision
    span counts up front (see module doc).  Handlers without a formula
    (scatter, materialize) degrade to the per-emit gated/skimmed path.

    Spans that only *partially* overlap a window never walk their whole
    Python emission loop: :meth:`_slice_nested` jumps straight to the
    overlapping elements through the span's affine virtual layout, so a
    3M-element span with one 2k window inside costs O(window), not
    O(span).  Spans under ``SLICE_MIN`` virtual slots just run the gated
    exact loop — identical bytes, bounded cost.
    """

    m: _SamplingMachine

    #: below this span length the gated exact loop beats slicing setup
    SLICE_MIN = 4096

    def _emit_checked(self, fn, total: int, what: str):
        m = self.m
        v0 = m.virtual
        out = fn()
        if m.virtual - v0 != total:
            raise AssertionError(
                f"sampling span drift in {what}: predicted {total} virtual "
                f"instructions, walked {m.virtual - v0} — count formula out "
                f"of sync with the exact emission loop")
        return out

    def _slice_nested(self, n_outer: int, prefix_rows: int, n_inner: int,
                      inner_rows: int, suffix_rows: int,
                      emit_prefix, emit_inner, emit_suffix) -> None:
        """Emit only the window-overlapping cells of a span laid out as
        ``n_outer`` × (prefix rows, ``n_inner`` × (overhead + inner rows),
        suffix rows).

        Cell and iteration start positions are affine in the indices (plus
        the amortized-branch correction), so inactive stretches are skipped
        by assigning ``virtual``/``_ov_count`` directly; the machine's
        deferred-crossing sync keeps window marks exact because skipped
        stretches never contain an emitting slot.
        """
        m = self.m
        U = m.UNROLL
        bounds = m._bounds_arr
        v0, c0 = m.virtual, m._ov_count
        cell_rows = prefix_rows + suffix_rows + n_inner * (inner_rows + 1)
        oi = np.arange(n_outer + 1, dtype=np.int64)
        os_ = v0 + oi * cell_rows + (c0 + oi * n_inner) // U - c0 // U
        act_o = _active(bounds, os_[:-1], os_[1:])
        ii = np.arange(n_inner + 1, dtype=np.int64)
        per_inner = inner_rows + 1
        for i in map(int, np.flatnonzero(act_o)):
            m.virtual = int(os_[i])
            m._ov_count = c0 + i * n_inner
            emit_prefix(i)
            vi, ci = m.virtual, m._ov_count
            is_ = vi + ii * per_inner + (ci + ii) // U - ci // U
            act_i = _active(bounds, is_[:-1], is_[1:])
            for j in map(int, np.flatnonzero(act_i)):
                m.virtual = int(is_[j])
                m._ov_count = ci + j
                emit_inner(i, j)
            m.virtual = int(is_[-1])
            m._ov_count = ci + n_inner
            emit_suffix(i)
        m.virtual = int(os_[-1])
        m._ov_count = c0 + n_outer * n_inner

    # ------------------------------------------------------- elementwise
    def _elementwise(self, op, invals, out_data):
        m = self.m
        out_data = np.asarray(out_data)
        n = out_data.size
        n_mem = 0
        for v in invals:
            if v.addr is not None:
                n_mem += 1
        total = m.span_total(n, n * (2 + n_mem))
        if m.take_bulk(total, n, ((OP_CODE[op], n),), n * n_mem, n, 1, n):
            return Value(out_data, m.alloc(out_data.shape, out_data.dtype))
        if total < self.SLICE_MIN or m.span_inside(total):
            return self._emit_checked(
                lambda: super(SamplingInterpreter, self)._elementwise(
                    op, invals, out_data), total, f"elementwise:{op}")
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        tag = _dtype_tag(out_data.dtype)
        osize = _itemsize(out_data.dtype)
        srcs = []
        for v in invals:
            data = np.asarray(v.data)
            srcs.append((np.broadcast_to(data, out_data.shape),
                         None if v.addr is None
                         else np.broadcast_to(v.addr, out_data.shape),
                         _dtype_tag(data.dtype), _itemsize(data.dtype)))
        oa = out_addr.ravel()

        def inner(_, i):
            m.emit_loop_overhead()
            row = []
            for bd, ba, stag, ssize in srcs:
                if ba is None:
                    row.append((SRC_IMM, bd.flat[i].item()))
                else:
                    row.append((SRC_REG,
                                m.emit_load(int(ba.flat[i]), stag, ssize)))
            rd = m.emit_op(op, tag, row)
            m.emit_store(int(oa[i]), rd, tag, osize)

        def run():
            self._slice_nested(1, 0, n, 2 + n_mem, 0, _noop, inner, _noop)
            return Value(out_data, out_addr)
        return self._emit_checked(run, total, f"elementwise:{op}")

    # --------------------------------------------------------- reductions
    def _reduce(self, op, inval, axes, out_data, init_imm):
        m = self.m
        x = np.asarray(inval.data)
        red_n = 1
        for a in axes:
            red_n *= x.shape[a]
        r = x.size // max(1, red_n)
        has = inval.addr is not None
        total = m.span_total(r * red_n, r * (2 + red_n * (1 + has)))
        ops = ((_OP_MOV, r), (OP_CODE[op], r * red_n))
        if m.take_bulk(total, r * red_n, ops, r * red_n if has else 0, r,
                       red_n, r * red_n):
            out_data = np.asarray(out_data)
            return Value(out_data, m.alloc(out_data.shape, out_data.dtype))
        if total < self.SLICE_MIN or m.span_inside(total):
            return self._emit_checked(
                lambda: super(SamplingInterpreter, self)._reduce(
                    op, inval, axes, out_data, init_imm), total,
                f"reduce:{op}")
        out_data = np.asarray(out_data)
        tag = _dtype_tag(out_data.dtype)
        osize = _itemsize(out_data.dtype)
        ssize = _itemsize(x.dtype)
        keep = [a for a in range(x.ndim) if a not in axes]
        perm = keep + list(axes)
        xa2 = (np.transpose(inval.addr, perm).reshape(-1, red_n)
               if has else None)
        xd2 = np.transpose(x, perm).reshape(-1, red_n)
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        oa = out_addr.ravel()
        acc = [0]

        def prefix(i):
            acc[0] = m.emit_op("mov", tag, ((SRC_IMM, init_imm),))

        def inner(i, j):
            m.emit_loop_overhead()
            if xa2 is None:
                src = (SRC_IMM, xd2[i, j].item())
            else:
                src = (SRC_REG, m.emit_load(int(xa2[i, j]), tag, ssize))
            acc[0] = m.emit_op(op, tag, ((SRC_REG, acc[0]), src), dst=acc[0])

        def suffix(i):
            m.emit_store(int(oa[i]), acc[0], tag, osize)

        def run():
            self._slice_nested(r, 1, red_n, 1 + has, 1,
                               prefix, inner, suffix)
            return Value(out_data, out_addr)
        return self._emit_checked(run, total, f"reduce:{op}")

    def _argreduce(self, inval, axis, out_data):
        m = self.m
        x = np.asarray(inval.data)
        red_n = x.shape[axis]
        r = x.size // max(1, red_n)
        has = inval.addr is not None
        inner = red_n - 1
        total = m.span_total(r * inner, r * (3 + 4 * inner))
        movs = r + (0 if has else r * red_n)
        ops = ((_OP_MOV, movs), (_OP_CMP, r * inner), (_OP_SEL, 2 * r * inner))
        if m.take_bulk(total, r * inner, ops, r * red_n if has else 0, r,
                       red_n, r * inner):
            out_data = np.asarray(out_data)
            return Value(out_data, m.alloc(out_data.shape, out_data.dtype))
        if total < self.SLICE_MIN or m.span_inside(total):
            return self._emit_checked(
                lambda: super(SamplingInterpreter, self)._argreduce(
                    inval, axis, out_data), total, "argreduce")
        out_data = np.asarray(out_data)
        perm = [a for a in range(x.ndim) if a != axis] + [axis]
        xa2 = (np.transpose(inval.addr, perm).reshape(-1, red_n)
               if has else None)
        xd2 = np.transpose(x, perm).reshape(-1, red_n)
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        oa = out_addr.ravel()
        tag = _dtype_tag(x.dtype)
        ssize = _itemsize(x.dtype)
        osize = _itemsize(out_data.dtype)
        st = [0, 0]                          # best, bidx registers

        def prefix(i):
            st[0] = m.emit_op("mov", tag, ((SRC_IMM, xd2[i, 0].item()),)) \
                if xa2 is None else m.emit_load(int(xa2[i, 0]), tag, ssize)
            st[1] = m.emit_op("mov", "i", ((SRC_IMM, 0),))

        def inner_fn(i, jm1):
            j = jm1 + 1
            m.emit_loop_overhead()
            if xa2 is None:
                cur = m.emit_op("mov", tag, ((SRC_IMM, xd2[i, j].item()),))
            else:
                cur = m.emit_load(int(xa2[i, j]), tag, ssize)
            c = m.emit_op("cmp", tag, ((SRC_REG, cur), (SRC_REG, st[0])))
            st[0] = m.emit_op("sel", tag, ((SRC_REG, c), (SRC_REG, cur),
                                           (SRC_REG, st[0])), dst=st[0])
            st[1] = m.emit_op("sel", "i", ((SRC_REG, c), (SRC_IMM, j),
                                           (SRC_REG, st[1])), dst=st[1])

        def suffix(i):
            m.emit_store(int(oa[i]), st[1], "i", osize)

        def run():
            self._slice_nested(r, 2, inner, 4, 1, prefix, inner_fn, suffix)
            return Value(out_data, out_addr)
        return self._emit_checked(run, total, "argreduce")

    # -------------------------------------------------------- dot_general
    def _dot_general(self, a, b, dnums, out_data):
        m = self.m
        (lc, rc), (lb, rb) = dnums
        A, B = np.asarray(a.data), np.asarray(b.data)
        nb = 1
        for i in lb:
            nb *= A.shape[i]
        K = 1
        for i in lc:
            K *= A.shape[i]
        cells = 0 if A.size == 0 or B.size == 0 else \
            (A.size // (nb * K)) * (B.size // (nb * K)) * nb
        ka = 1 if a.addr is not None else 0
        kb = 1 if b.addr is not None else 0
        total = m.span_total(cells * K, cells * (2 + K * (2 + ka + kb)))
        ops = ((_OP_MOV, cells), (_OP_MUL, cells * K), (_OP_ADD, cells * K))
        if m.take_bulk(total, cells * K, ops, cells * K * (ka + kb), cells,
                       K, cells * K):
            out_data = np.asarray(out_data)
            return Value(out_data, m.alloc(out_data.shape, out_data.dtype))
        if total < self.SLICE_MIN or m.span_inside(total):
            return self._emit_checked(
                lambda: super(SamplingInterpreter, self)._dot_general(
                    a, b, dnums, out_data), total, "dot_general")

        def order(x, batch, contract):
            keep = [i for i in range(x.ndim) if i not in batch + contract]
            return list(batch) + keep + list(contract)

        pa, pb = order(A, tuple(lb), tuple(lc)), order(B, tuple(rb), tuple(rc))
        Mm = A.size // (nb * K)
        Nn = B.size // (nb * K)
        Ad3 = np.transpose(A, pa).reshape(nb, Mm, K)
        Bd3 = np.transpose(B, pb).reshape(nb, Nn, K)
        Aa3 = (np.transpose(a.addr, pa).reshape(nb, Mm, K) if ka else None)
        Ba3 = (np.transpose(b.addr, pb).reshape(nb, Nn, K) if kb else None)
        out_data = np.asarray(out_data)
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        oa3 = out_addr.reshape(nb, Mm, Nn)
        tag = _dtype_tag(out_data.dtype)
        asz, bsz = _itemsize(A.dtype), _itemsize(B.dtype)
        osize = _itemsize(out_data.dtype)
        cur = {}
        acc = [0]

        def prefix(c):
            bi, rem = divmod(c, Mm * Nn)
            i, j = divmod(rem, Nn)
            cur["aa"] = Aa3[bi, i] if Aa3 is not None else None
            cur["ad"] = Ad3[bi, i]
            cur["ba"] = Ba3[bi, j] if Ba3 is not None else None
            cur["bd"] = Bd3[bi, j]
            cur["oa"] = int(oa3[bi, i, j])
            acc[0] = m.emit_op("mov", tag, ((SRC_IMM, 0),))

        def inner(c, k):
            m.emit_loop_overhead()
            aa, ba = cur["aa"], cur["ba"]
            sa = ((SRC_REG, m.emit_load(int(aa[k]), tag, asz))
                  if aa is not None else (SRC_IMM, cur["ad"][k].item()))
            sb = ((SRC_REG, m.emit_load(int(ba[k]), tag, bsz))
                  if ba is not None else (SRC_IMM, cur["bd"][k].item()))
            prod = m.emit_op("mul", tag, (sa, sb))
            acc[0] = m.emit_op("add", tag, ((SRC_REG, acc[0]),
                                            (SRC_REG, prod)), dst=acc[0])

        def suffix(c):
            m.emit_store(cur["oa"], acc[0], tag, osize)

        def run():
            self._slice_nested(cells, 1, K, 2 + ka + kb, 1,
                               prefix, inner, suffix)
            return Value(out_data, out_addr)
        return self._emit_checked(run, total, "dot_general")

    # ------------------------------------------------------- copy family
    def _copy_to_new_buffer(self, src, out_data):
        m = self.m
        out_data = np.asarray(out_data)
        n = out_data.size
        has = src.addr is not None
        total = m.span_total(n, 2 * n)
        ops = () if has else ((_OP_MOV, n),)
        if m.take_bulk(total, n, ops, n if has else 0, n, 1, n):
            return Value(out_data, m.alloc(out_data.shape, out_data.dtype))
        if total < self.SLICE_MIN or m.span_inside(total):
            return self._emit_checked(
                lambda: super(SamplingInterpreter, self)._copy_to_new_buffer(
                    src, out_data), total, "copy")
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        tag = _dtype_tag(out_data.dtype)
        size = _itemsize(out_data.dtype)
        sa = src.addr.ravel() if has else None
        sd = np.asarray(src.data).ravel()
        oa = out_addr.ravel()

        def inner(_, i):
            m.emit_loop_overhead()
            if sa is None:
                r = m.emit_op("mov", tag, ((SRC_IMM, sd[i].item()),))
            else:
                r = m.emit_load(int(sa[i]), tag, size)
            m.emit_store(int(oa[i]), r, tag, size)

        def run():
            self._slice_nested(1, 0, n, 2, 0, _noop, inner, _noop)
            return Value(out_data, out_addr)
        return self._emit_checked(run, total, "copy")

    def _concat_copy(self, fake, out):
        m = self.m
        n = out.size
        n_imm = int((fake.addr.ravel() < 0).sum())
        total = m.span_total(n, 2 * n)
        if m.take_bulk(total, n, ((_OP_MOV, n_imm),), n - n_imm, n, 1, n):
            return Value(out, m.alloc(out.shape, out.dtype))
        if total < self.SLICE_MIN or m.span_inside(total):
            return self._emit_checked(
                lambda: super(SamplingInterpreter, self)._concat_copy(
                    fake, out), total, "concat")
        out_addr = m.alloc(out.shape, out.dtype)
        tag = _dtype_tag(out.dtype)
        size = _itemsize(out.dtype)
        sa = fake.addr.ravel()
        sd = out.ravel()
        oa = out_addr.ravel()

        def inner(_, i):
            m.emit_loop_overhead()
            if sa[i] < 0:
                r = m.emit_op("mov", tag, ((SRC_IMM, sd[i].item()),))
            else:
                r = m.emit_load(int(sa[i]), tag, size)
            m.emit_store(int(oa[i]), r, tag, size)

        def run():
            self._slice_nested(1, 0, n, 2, 0, _noop, inner, _noop)
            return Value(out, out_addr)
        return self._emit_checked(run, total, "concat")

    def _store_region(self, base, update, sl):
        m = self.m
        n = np.asarray(update.data).size
        has = update.addr is not None
        total = m.span_total(n, 2 * n)
        ops = () if has else ((_OP_MOV, n),)
        if m.take_bulk(total, n, ops, n if has else 0, n, 1, n):
            return None
        if total < self.SLICE_MIN or m.span_inside(total):
            return self._emit_checked(
                lambda: super(SamplingInterpreter, self)._store_region(
                    base, update, sl), total, "store_region")
        ud = np.asarray(update.data)
        tag = _dtype_tag(ud.dtype)
        size = _itemsize(ud.dtype)
        ua = update.addr.ravel() if has else None
        udf = ud.ravel()
        ta = base.addr[sl].ravel()

        def inner(_, i):
            m.emit_loop_overhead()
            if ua is None:
                r = m.emit_op("mov", tag, ((SRC_IMM, udf[i].item()),))
            else:
                r = m.emit_load(int(ua[i]), tag, size)
            m.emit_store(int(ta[i]), r, tag, size)

        def run():
            self._slice_nested(1, 0, n, 2, 0, _noop, inner, _noop)
        return self._emit_checked(run, total, "store_region")

    def _gather_pointer_chase(self, operand, out_data, gathered_addrs,
                              index_srcs):
        m = self.m
        out_data = np.asarray(out_data)
        n = out_data.size
        hi = 1 if (index_srcs is not None
                   and index_srcs.addr is not None) else 0
        total = m.span_total(n, n * (2 + 2 * hi))
        if m.take_bulk(total, n, ((_OP_AGEN, n * hi),), n * (1 + hi), n,
                       2, n):
            return Value(out_data, m.alloc(out_data.shape, out_data.dtype))
        if total < self.SLICE_MIN or m.span_inside(total):
            return self._emit_checked(
                lambda: super(
                    SamplingInterpreter, self)._gather_pointer_chase(
                        operand, out_data, gathered_addrs, index_srcs),
                total, "gather")
        out_addr = m.alloc(out_data.shape, out_data.dtype)
        tag = _dtype_tag(out_data.dtype)
        size = _itemsize(out_data.dtype)
        ia = (index_srcs.addr.ravel() if hi else None)
        id_flat = (np.asarray(index_srcs.data).ravel()
                   if index_srcs is not None else None)
        ga = gathered_addrs.ravel()
        oa = out_addr.ravel()
        n_idx = len(id_flat) if id_flat is not None else 0

        def inner(_, i):
            m.emit_loop_overhead()
            if ia is not None:
                ri = m.emit_load(int(ia[i % n_idx]), "i", 4)
                m.emit_op("agen", "i", ((SRC_REG, ri), (SRC_IMM, 0)))
            r = m.emit_load(int(ga[i]), tag, size)
            m.emit_store(int(oa[i]), r, tag, size)

        def run():
            self._slice_nested(1, 0, n, 2 + 2 * hi, 0, _noop, inner, _noop)
            return Value(out_data, out_addr)
        return self._emit_checked(run, total, "gather")


# ======================================================================
# Drivers
# ======================================================================
@dataclasses.dataclass
class SkimResult:
    """The feature pass: per-interval structural features + stream length."""
    features: np.ndarray       # [n_intervals, N_FEATURES]
    total_virtual: int
    interval: int

    @property
    def n_intervals(self) -> int:
        return self.features.shape[0]


@dataclasses.dataclass
class WindowedTrace:
    """The sampled emission pass: one columnar trace holding only the
    sampled windows, plus per-window builder row ranges."""
    structural: StructuralTrace
    marks: List[Tuple[int, int, int]]   # (window index, row lo, row hi)
    total_virtual: int


def skim_program(fn, *args, interval: int, n_regs: int = 24) -> SkimResult:
    """Run the feature-columns-only pass over ``fn(*args)``."""
    m = SkimMachine(interval, n_regs=n_regs)
    run_program(SamplingInterpreter(m), fn, *args)
    return SkimResult(features=m.features(), total_virtual=m.virtual,
                      interval=interval)


def trace_windows(fn, *args, windows: Sequence[Tuple[int, int]],
                  n_regs: int = 24,
                  limits: TraceLimits = TraceLimits(),
                  expect_total: Optional[int] = None,
                  device="cuda") -> WindowedTrace:
    """Trace only the given ``[lo, hi)`` virtual windows of ``fn(*args)``,
    the columns on ``device``.

    ``expect_total`` (the skim's ``total_virtual``) cross-checks that the
    two passes walked the same virtual stream.
    """
    dev = resolve_device(device)
    bounds: List[int] = []
    for lo, hi in windows:
        if bounds and lo < bounds[-1]:
            raise ValueError("windows must be sorted and non-overlapping")
        bounds.extend((int(lo), int(hi)))
    m = WindowedMachine(bounds, n_regs=n_regs, limits=limits)
    outs = run_program(SamplingInterpreter(m), fn, *args)
    marks = m.finish_marks()
    if expect_total is not None and m.virtual != expect_total:
        raise AssertionError(
            f"windowed pass walked {m.virtual} virtual instructions, "
            f"skim walked {expect_total} — passes diverged")
    st = StructuralTrace(m.b.finish(m.n_regs, device=dev),
                         [torch.from_numpy(np.array(v.data)) for v in outs])
    return WindowedTrace(structural=st, marks=marks, total_virtual=m.virtual)
