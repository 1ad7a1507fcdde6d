"""Batched cache replay: ``CacheHierarchy.replay`` for many geometries.

Twin of ``repro/core/accel/replay.py``.  One launch of the CUDA kernel
(``csrc/replay.cu``) replays one access stream under every geometry of a
depth -- one thread block per geometry -- and returns, per geometry, the
four memory-response columns of :meth:`CacheHierarchy.replay` (same
dtypes) and the :meth:`CacheHierarchy.counters` dict.  The plain version,
which CPU tensors take, is the OrderedDict machine itself.

The reference's ``None`` return (int32 overflow -> numpy fallback) has no
counterpart: the kernel keeps lines and LRU stamps in int64.  Inputs the
kernel does not take (negative addresses, depth other than 1 or 2, more
than 32 ways or MSHR entries) raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.accel import _build, count_launch
from repro_torch.core.cache import LINE, CacheConfig, CacheHierarchy
from repro_torch.core.isa import LEVEL_CODE, LEVEL_MEM

#: first-level state (tags, stamps: 8 bytes; dirty: 1) kept in shared
#: memory when it fits the default 48 KB dynamic allowance
_SMEM_BYTES = 48 * 1024
_WAY_BYTES = 17

_SIG = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)

Columns = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                Dict[str, int]]


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


def _check_geometry(levels: Tuple[CacheConfig, ...]) -> None:
    if len(levels) not in (1, 2):
        raise ValueError(f"the replay kernel takes 1 or 2 cache levels, "
                         f"got {len(levels)}")
    for c in levels:
        if not (1 <= c.assoc <= 32 and 1 <= c.mshrs <= 32 and c.banks >= 1):
            raise ValueError(f"{c}: the replay kernel takes 1..32 ways and "
                             "MSHR entries and at least one bank")


def _replay_cuda(addrs, is_writes, geometries) -> List[Columns]:
    dev = addrs.device
    n = addrs.numel()
    if addrs.dtype != torch.int64:
        raise TypeError(f"int64 addresses expected, got {addrs.dtype}")
    if n and int(addrs.min()) < 0:
        raise ValueError("negative address in the replay stream")
    lines = torch.div(addrs, LINE, rounding_mode="floor").contiguous()
    wr = is_writes.to(torch.uint8).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib, fn = _build.function(_build.CSRC / "replay.cu", "replay_batch",
                              _SIG)

    results: List[Columns] = [None] * len(geometries)
    by_depth: Dict[int, List[int]] = {}
    for gi, levels in enumerate(geometries):
        _check_geometry(levels)
        by_depth.setdefault(len(levels), []).append(gi)
    for depth, idxs in sorted(by_depth.items()):
        l0_ways = max(geometries[gi][0].n_sets * geometries[gi][0].assoc
                      for gi in idxs)
        l0_shared = l0_ways * _WAY_BYTES <= _SMEM_BYTES
        params, n_ways = [], 0
        for gi in idxs:
            for li, c in enumerate(geometries[gi]):
                off = 0
                if li or not l0_shared:
                    off, n_ways = n_ways, n_ways + c.n_sets * c.assoc
                params += [c.n_sets, c.assoc, c.banks, c.mshrs, off]
        params = torch.tensor(params, dtype=torch.int64, device=dev)
        g = len(idxs)
        tags = torch.empty(n_ways, dtype=torch.int64, device=dev)
        stamp = torch.empty(n_ways, dtype=torch.int64, device=dev)
        dirty = torch.empty(n_ways, dtype=torch.uint8, device=dev)
        service = torch.empty((g, n), dtype=torch.int8, device=dev)
        merged = torch.empty((g, n), dtype=torch.uint8, device=dev)
        bank = torch.empty((g, n), dtype=torch.int16, device=dev)
        counters = torch.empty((g, 3 * depth + 2), dtype=torch.int64,
                               device=dev)
        rc = fn(lines.data_ptr(), wr.data_ptr(), n, params.data_ptr(), g,
                depth, int(l0_shared), l0_ways if l0_shared else 0,
                tags.data_ptr(), stamp.data_ptr(), dirty.data_ptr(),
                service.data_ptr(), merged.data_ptr(), bank.data_ptr(),
                counters.data_ptr(), stream)
        _build.check(lib, rc, "replay launch")
        count_launch("replay")
        for r, (gi, cnt) in enumerate(zip(idxs, counters.tolist())):
            levels = geometries[gi]
            codes = torch.tensor([LEVEL_CODE[c.name] for c in levels]
                                 + [LEVEL_MEM], dtype=torch.int8, device=dev)
            sv = service[r].to(torch.int64)
            counts = {"mem_reads": cnt[3 * depth],
                      "mem_writes": cnt[3 * depth + 1]}
            for li, c in enumerate(levels):
                counts[f"{c.name}_hits"] = cnt[li]
                counts[f"{c.name}_misses"] = cnt[depth + li]
                counts[f"{c.name}_writebacks"] = cnt[2 * depth + li]
            results[gi] = (codes[sv - 1], (sv == 1).to(torch.int8), bank[r],
                           merged[r].to(torch.bool), counts)
    return results
