"""Placement on the card: the vectorized half of Algorithm 1.

Twin of ``repro/core/accel/place.py`` (``place_candidates_jax``, plain JAX
in the reference).  Per structural proto-candidate it computes against one
geometry's level/addr/bank columns:

  1. the target level -- the deepest leaf depth, clamped to the deepest
     CiM-capable level and lifted to the shallowest enabled level;
  2. the operand moves -- the leaves shallower than the target;
  3. the DRAM fills -- the distinct cache lines among the proto's
     accesses that main memory served;
  4. the home bank -- the bank of the proto's first converted load.

The flat structural arrays -- leaf and access sequence ids with CSR
offsets, so each proto's leaves and accesses are one contiguous run, and
each proto's first load -- are memoized per partition key on the trace's
shared ``_struct`` dict, so every geometry of a sweep reuses them.

A CUDA trace launches the kernel ``csrc/place.cu`` (one warp per proto,
one launch a call), which reads the trace columns in place and, for
:func:`placement_lists`, also copies its (4, n_protos) result to pinned
host memory and synchronises, all in one ctypes call.  A CPU trace takes
the plain version, :func:`_plain`.  Neither packs (proto, line) into one
key, so no address or proto count is out of range.

:func:`place_sorted` computes the same four rows another way: from the
segment kernels and one sort of packed ``proto << 40 | line`` keys, on the
trace's device.  It is a second, independent formulation that the tests
hold the plain version to and that ``chip_smoke.py`` times the kernel
against; the pipeline does not call it.
"""
from __future__ import annotations

import ctypes
import itertools
from typing import List, Tuple

import torch

from repro_torch.core.accel import _build, count_launch
from repro_torch.core.accel.pallas_ops import segment_max, segment_sum
from repro_torch.core.isa import LEVEL_MEM

_LINE_BITS = 40

_SIG = (*(ctypes.c_void_p,) * 8, ctypes.c_int64, ctypes.c_uint, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
# the column dtypes the kernel reads (repro_torch.core.columnar)
_COLUMNS = (("level", torch.int8), ("addr", torch.int64),
            ("bank", torch.int16))


def _flat_arrays(part, ct, cfg) -> Tuple[torch.Tensor, ...]:
    """``(leaf_seq, leaf_off, acc_seq, acc_off, first_load)`` on the
    trace's device: proto ``p``'s leaves are ``leaf_seq[leaf_off[p]:
    leaf_off[p + 1]]``, its accesses (loads, then stores) likewise, all
    int64."""
    memo = ct._struct.setdefault("place_flat", {})
    key = cfg.partition_key()
    flat = memo.get(key)
    if flat is not None:
        return flat
    protos = part.protos

    def csr(seq_lists):
        off = torch.zeros(len(seq_lists) + 1, dtype=torch.int64)
        torch.cumsum(torch.tensor([len(s) for s in seq_lists],
                                  dtype=torch.int64), 0, out=off[1:])
        seqs = torch.tensor(list(itertools.chain.from_iterable(seq_lists)),
                            dtype=torch.int64)
        return seqs.to(ct.device), off.to(ct.device)

    first_load = torch.tensor([p.load_seqs[0] if p.load_seqs else 0
                               for p in protos], dtype=torch.int64)
    flat = memo[key] = (*csr([p.leaf_src for p in protos]),
                        *csr([p.load_seqs + p.store_seqs for p in protos]),
                        first_load.to(ct.device))
    return flat


def _depths(cfg) -> Tuple[Tuple[int, ...], int]:
    """(the enabled CiM depths in ascending order, the deepest of them)."""
    from repro_torch.core.offload import _LEVEL_DEPTH

    enabled = tuple(sorted(_LEVEL_DEPTH[l] for l in cfg.cim_levels))
    return enabled, enabled[-1]


def _plain(ct, flat, enabled, depth_cap: int) -> torch.Tensor:
    """The plain version: (target, moves, fills, bank) per proto as one
    (4, n_protos) int32 tensor, by scatter reductions and a unique of
    (proto, line) rows."""
    leaf_seq, leaf_off, acc_seq, acc_off, first_load = flat
    n = first_load.numel()
    protos = torch.arange(n, device=first_load.device)
    leaf_pid = torch.repeat_interleave(protos, leaf_off.diff())
    acc_pid = torch.repeat_interleave(protos, acc_off.diff())

    depth = torch.clamp(ct.level[leaf_seq].to(torch.int32) - 1,
                        max=depth_cap)
    deepest = torch.zeros(n, dtype=torch.int32, device=depth.device)
    deepest.scatter_reduce_(0, leaf_pid, depth, "amax")     # empty: 0
    levels = torch.tensor(enabled, dtype=torch.int32, device=depth.device)
    target = levels[torch.clamp(torch.searchsorted(levels, deepest),
                                max=len(enabled) - 1)]
    moves = torch.zeros_like(deepest).index_add_(
        0, leaf_pid, (depth < target[leaf_pid]).to(torch.int32))

    mem = ct.level[acc_seq] == LEVEL_MEM
    pairs = torch.stack([acc_pid[mem], ct.addr[acc_seq[mem]] >> 6], dim=1)
    fills = torch.bincount(torch.unique(pairs, dim=0)[:, 0], minlength=n)
    return torch.stack([target, moves, fills.to(torch.int32),
                        ct.bank[first_load].to(torch.int32)])


def _launch(ct, flat, enabled, depth_cap: int, host=None) -> torch.Tensor:
    """One launch of the kernel; with ``host`` (pinned, (4, n) int32) the
    result is on the host when this returns."""
    for name, dtype in _COLUMNS:
        col = getattr(ct, name)
        if col.dtype != dtype or not col.is_contiguous():
            raise TypeError(f"column {name}: contiguous {dtype} expected, "
                            f"got {col.dtype}")
    leaf_seq, leaf_off, acc_seq, acc_off, first_load = flat
    n = first_load.numel()
    out = torch.empty((4, n), dtype=torch.int32, device=first_load.device)
    lib, fn = _build.function(_build.CSRC / "place.cu", "place", _SIG)
    rc = fn(ct.level.data_ptr(), ct.addr.data_ptr(), ct.bank.data_ptr(),
            leaf_seq.data_ptr(), leaf_off.data_ptr(), acc_seq.data_ptr(),
            acc_off.data_ptr(), first_load.data_ptr(), n,
            sum(1 << d for d in enabled), depth_cap, out.data_ptr(),
            None if host is None else host.data_ptr(),
            torch._C._cuda_getCurrentRawStream(first_load.get_device()))
    _build.check(lib, rc, "place launch")
    count_launch("place")
    return out


def place_arrays(part, ct, cfg, host=None) -> torch.Tensor:
    """(target depth, moves, fills, bank) per proto: one (4, n_protos)
    int32 tensor on the trace's device.  ``part`` has at least one proto.
    On a CUDA trace, with ``host`` (pinned, (4, n_protos) int32) the result
    is also on the host when this returns."""
    flat = _flat_arrays(part, ct, cfg)
    enabled, depth_cap = _depths(cfg)
    if ct.device.type == "cuda":
        return _launch(ct, flat, enabled, depth_cap, host)
    if ct.device.type == "cpu":
        return _plain(ct, flat, enabled, depth_cap)
    raise ValueError(f"unsupported device {ct.device}")


def placement_lists(part, ct, cfg) -> List[List[int]]:
    """:func:`place_arrays` as four lists on the host: on a CUDA trace one
    launch, one copy to pinned memory and one synchronisation."""
    if ct.device.type != "cuda":
        return place_arrays(part, ct, cfg).tolist()
    host = torch.empty((4, len(part.protos)), dtype=torch.int32,
                       pin_memory=True)
    place_arrays(part, ct, cfg, host)
    return host.tolist()


def place_candidates(part, ct, cfg) -> List:
    """``_place`` on the trace's device: the placement kernel on a CUDA
    trace, its plain version on a CPU trace."""
    from repro_torch.core.offload import _candidates

    if not part.protos:
        return []
    return _candidates(part.protos, *placement_lists(part, ct, cfg))


def place_sorted(part, ct, cfg) -> torch.Tensor:
    """:func:`place_arrays` from the segment kernels and a sort of packed
    (proto, line) keys.  Raises where a key would not fit int64: 2**22
    protos or more, or a line of 2**40 or more."""
    memo = ct._struct.setdefault("place_pid", {})
    leaf_seq, leaf_off, acc_seq, acc_off, first_load = \
        _flat_arrays(part, ct, cfg)
    n_seg = first_load.numel()
    pids = memo.get(cfg.partition_key())
    if pids is None:
        if n_seg >= 2 ** 22 or (
                len(acc_seq) and int(ct.addr[acc_seq].max()) // 64
                >= 2 ** _LINE_BITS):
            raise ValueError("placement key (proto, line) exceeds int64")
        protos = torch.arange(n_seg, dtype=torch.int32, device=ct.device)
        pids = memo[cfg.partition_key()] = (
            torch.repeat_interleave(protos, leaf_off.diff()),
            torch.repeat_interleave(protos, acc_off.diff()))
    leaf_pid, acc_pid = pids
    enabled, depth_cap = _depths(cfg)
    enabled = torch.tensor(enabled, dtype=torch.int32, device=ct.device)

    # target level: deepest leaf (DRAM clamped to the cap), lifted to the
    # shallowest enabled depth; empty segments place at depth 0
    depth = torch.clamp(ct.level[leaf_seq].to(torch.int32) - 1,
                        max=depth_cap)
    max_depth = torch.clamp(segment_max(depth, leaf_pid, n_seg), min=0)
    tpos = torch.clamp(torch.searchsorted(enabled, max_depth),
                       max=len(enabled) - 1)
    target = enabled[tpos]

    # moves: leaves resident shallower than the target level
    shallower = (depth < target[leaf_pid]).to(torch.int32)
    moves = segment_sum(shallower, leaf_pid, n_seg)

    # DRAM fills: unique (proto, line) among MEM-served accesses; other
    # accesses carry the sentinel proto n_seg, which the kernel drops
    pid_k = torch.where(ct.level[acc_seq] == LEVEL_MEM, acc_pid,
                        n_seg).to(torch.int64)
    keys = torch.sort((pid_k << _LINE_BITS)
                      + torch.div(ct.addr[acc_seq], 64,
                                  rounding_mode="floor")).values
    head = torch.ones_like(keys, dtype=torch.bool)
    head[1:] = keys[1:] != keys[:-1]
    fills = segment_sum(head.to(torch.int32),
                        (keys >> _LINE_BITS).to(torch.int32), n_seg)
    return torch.stack([target, moves, fills,
                        ct.bank[first_load].to(torch.int32)])
