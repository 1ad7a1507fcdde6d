"""Batched cache replay: ``CacheHierarchy.replay`` for many geometries.

Twin of ``repro/core/accel/replay.py``.  One launch of the CUDA kernel
(``csrc/replay.cu``) replays one access stream under every geometry of a
depth -- one thread block per geometry -- and returns, per geometry, the
four memory-response columns of :meth:`CacheHierarchy.replay` (same
dtypes) and the :meth:`CacheHierarchy.counters` dict, all written by the
kernel.  The plain version, which CPU tensors take, is the OrderedDict
machine itself.

The reference's ``None`` return (int32 overflow -> numpy fallback) has no
counterpart: the kernel comes in 32-bit and 64-bit instantiations, and
:func:`word_bytes` picks the 64-bit one for a stream whose length or
largest line would not fit 32-bit LRU stamps and set-local tags.  Inputs
the kernel does not take (negative addresses, depth other than 1 or 2,
more than 32 ways or MSHR entries) raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.accel import _build, count_launch
from repro_torch.core.cache import LINE, CacheConfig, CacheHierarchy
from repro_torch.core.isa import LEVEL_CODE, LEVEL_MEM

#: shared memory a block may use on the H100; a first level whose state
#: fits lives there
_SMEM_BYTES = 232448
_LINE_SHIFT = LINE.bit_length() - 1
#: accesses the kernel probes at once (csrc/replay.cu ``kStep``), and the
#: shared-memory ring that stages the stream after the first level: four
#: steps of an 8-byte address and a flag byte each
STEP = 64
_RING_BYTES = 4 * STEP * 9
#: the kernel's source (a probe may point it at another source with the
#: same C interface)
SRC = _build.CSRC / "replay.cu"
#: a 32-bit word's largest value marks an empty way (tags) and a lane that
#: holds no way (stamps)
_WORD32_MAX = 2 ** 32 - 1

_SIG = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)

Columns = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                Dict[str, int]]

#: (geometries of a launch, first level shared, device) -> (params
#: tensor, ways in the global scratch)
_params: Dict[tuple, Tuple[torch.Tensor, int]] = {}


# lint: numpy-twin(repro_torch.core.cache:CacheHierarchy.replay, batched)
def replay_columns_batch(addrs: torch.Tensor, is_writes: torch.Tensor,
                         geometries: Sequence[Tuple[CacheConfig, ...]]
                         ) -> List[Columns]:
    """Replay one access stream under every geometry.

    Returns, per geometry, ``(level int8, hit int8, bank int16, mshr bool,
    counters)`` on the device of ``addrs``."""
    if addrs.dim() != 1 or is_writes.shape != addrs.shape:
        raise ValueError("addrs and is_writes must be equal 1-D shapes")
    if addrs.device.type == "cuda":
        return _replay_cuda(addrs, is_writes, geometries)
    if addrs.device.type != "cpu":
        raise ValueError(f"unsupported device {addrs.device}")
    out = []
    for levels in geometries:
        hier = CacheHierarchy(levels)
        out.append((*hier.replay(addrs, is_writes), hier.counters()))
    return out


# lint: disable=accel-parity (launches nothing: the kernel's word size)
def word_bytes(n: int, max_line: int,
               geometries: Sequence[Tuple[CacheConfig, ...]]) -> int:
    """Bytes of the kernel's tag and LRU-stamp words for a stream of ``n``
    accesses whose largest line is ``max_line``: 4 when every stamp (at
    most three touches an access) and every set-local tag (``line //
    sets``) stays below the 32-bit empty mark, else 8."""
    min_sets = min(c.n_sets for levels in geometries for c in levels)
    return 4 if (3 * n < _WORD32_MAX
                 and max_line // min_sets < _WORD32_MAX) else 8


# lint: disable=accel-parity (launches nothing: the kernel's L1 placement)
def first_level_shared(geometries: Sequence[Tuple[CacheConfig, ...]],
                       word: int) -> bool:
    """True when the largest first level of ``geometries``, in ``word``-byte
    tags and stamps and a dirty byte a way, fits in shared memory beside
    the kernel's ring of the stream."""
    l0_ways = max(levels[0].n_sets * levels[0].assoc for levels in geometries)
    return -(-l0_ways * (2 * word + 1) // 16) * 16 + _RING_BYTES \
        <= _SMEM_BYTES


def _check_geometry(levels: Tuple[CacheConfig, ...]) -> None:
    if len(levels) not in (1, 2):
        raise ValueError(f"the replay kernel takes 1 or 2 cache levels, "
                         f"got {len(levels)}")
    for c in levels:
        if not (1 <= c.assoc <= 32 and 1 <= c.mshrs <= 32 and c.banks >= 1):
            raise ValueError(f"{c}: the replay kernel takes 1..32 ways and "
                             "MSHR entries and at least one bank")


def _launch_params(geos, l0_shared: bool, dev) -> Tuple[torch.Tensor, int]:
    """The kernel's per-(geometry, level) parameters on ``dev`` and the
    ways the global scratch holds, memoized per launch shape."""
    key = (tuple(geos), l0_shared, dev)
    if key not in _params:
        rows, n_ways = [], 0
        for levels in geos:
            for li, c in enumerate(levels):
                off = 0
                if li or not l0_shared:
                    off, n_ways = n_ways, n_ways + c.n_sets * c.assoc
                sets = c.n_sets
                shift = sets.bit_length() - 1 if sets & (sets - 1) == 0 \
                    else -1
                rows += [sets, c.assoc, c.banks, c.mshrs, off, shift,
                         LEVEL_CODE[c.name]]
        _params[key] = (torch.tensor(rows, dtype=torch.int64, device=dev),
                        n_ways)
    return _params[key]


def _replay_cuda(addrs, is_writes, geometries) -> List[Columns]:
    dev = addrs.device
    n = addrs.numel()
    if addrs.dtype != torch.int64:
        raise TypeError(f"int64 addresses expected, got {addrs.dtype}")
    wr = (is_writes if is_writes.dtype == torch.bool else is_writes != 0)
    # the kernel stages the stream 16 bytes at a time
    addrs, wr = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
                 else x.clone(memory_format=torch.contiguous_format)
                 for x in (addrs, wr))
    lo, hi = torch.stack(torch.aminmax(addrs)).tolist() if n else (0, 0)
    if lo < 0:
        raise ValueError("negative address in the replay stream")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib, fn = _build.function(SRC, "replay_batch", _SIG)

    results: List[Columns] = [None] * len(geometries)
    by_depth: Dict[int, List[int]] = {}
    for gi, levels in enumerate(geometries):
        _check_geometry(levels)
        by_depth.setdefault(len(levels), []).append(gi)
    for depth, idxs in sorted(by_depth.items()):
        geos = [geometries[gi] for gi in idxs]
        word = word_bytes(n, hi >> _LINE_SHIFT, geos)
        way_bytes = 2 * word + 1
        l0_ways = max(levels[0].n_sets * levels[0].assoc for levels in geos)
        l0_shared = first_level_shared(geos, word)
        params, n_ways = _launch_params(geos, l0_shared, dev)
        g = len(idxs)
        scratch = torch.empty(n_ways * way_bytes, dtype=torch.uint8,
                              device=dev)
        level = torch.empty((g, n), dtype=torch.int8, device=dev)
        hit = torch.empty((g, n), dtype=torch.int8, device=dev)
        bank = torch.empty((g, n), dtype=torch.int16, device=dev)
        merged = torch.empty((g, n), dtype=torch.bool, device=dev)
        counters = torch.empty((g, 3 * depth + 2), dtype=torch.int64,
                               device=dev)
        rc = fn(addrs.data_ptr(), wr.data_ptr(), n, _LINE_SHIFT,
                params.data_ptr(), g, depth, int(word == 8), int(l0_shared),
                l0_ways, scratch.data_ptr(), n_ways, LEVEL_MEM,
                level.data_ptr(), hit.data_ptr(), bank.data_ptr(),
                merged.data_ptr(), counters.data_ptr(), stream)
        _build.check(lib, rc, "replay launch")
        count_launch("replay")
        for r, (gi, cnt) in enumerate(zip(idxs, counters.tolist())):
            counts = {"mem_reads": cnt[3 * depth],
                      "mem_writes": cnt[3 * depth + 1]}
            for li, c in enumerate(geometries[gi]):
                counts[f"{c.name}_hits"] = cnt[li]
                counts[f"{c.name}_misses"] = cnt[depth + li]
                counts[f"{c.name}_writebacks"] = cnt[2 * depth + li]
            results[gi] = (level[r], hit[r], bank[r], merged[r], counts)
    return results
