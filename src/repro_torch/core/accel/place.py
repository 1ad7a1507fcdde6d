"""Placement on the card: the vectorized half of Algorithm 1.

Twin of ``repro/core/accel/place.py`` (``place_candidates_jax``, plain JAX
in the reference).  Per structural proto-candidate it computes against one
geometry's level/bank columns:

  1. the deepest leaf depth -- :func:`segment_max`, clamped to the deepest
     CiM-capable level and lifted (``searchsorted``) to the shallowest
     enabled level: the target level;
  2. the operand moves -- :func:`segment_sum` of leaves shallower than the
     target;
  3. the DRAM fills -- unique (proto, line) pairs among MEM-served
     accesses: one int64 key ``proto << 40 | line`` sorted on the card,
     group heads :func:`segment_sum`-med per proto;
  4. the home bank -- a gather at each proto's first converted load.

Three segment-kernel launches per placement; the rest are torch ops on the
trace's device.  The flat structural arrays (leaf / access sequence ids
and their proto ids) are memoized per partition key on the trace's shared
``_struct`` dict, so every geometry of a sweep reuses them.  Unlike the
reference nothing is padded to a power of two: there is no compile cache
to share, and the sentinel proto id ``n_protos`` of non-MEM accesses falls
outside ``[0, n_segments)``, where the segment kernels drop it.

On a CPU trace the same composition runs over the segment ops' plain
versions: that is the plain version of placement.
"""
from __future__ import annotations

import itertools
from typing import List, Tuple

import torch

from repro_torch.core.accel.pallas_ops import segment_max, segment_sum
from repro_torch.core.isa import LEVEL_MEM

_LINE_BITS = 40


def _flat_arrays(part, ct, cfg) -> Tuple[torch.Tensor, ...]:
    """Structural flat views of the partition, on the trace's device."""
    memo = ct._struct.setdefault("place_flat", {})
    key = cfg.partition_key()
    flat = memo.get(key)
    if flat is not None:
        return flat
    protos = part.protos
    dev = ct.device

    def flat_of(seq_lists):
        counts = torch.tensor([len(s) for s in seq_lists], dtype=torch.int64)
        seqs = torch.tensor(list(itertools.chain.from_iterable(seq_lists)),
                            dtype=torch.int64)
        pid = torch.repeat_interleave(
            torch.arange(len(seq_lists), dtype=torch.int32), counts)
        return seqs.to(dev), pid.to(dev)

    leaf_seq, leaf_pid = flat_of([p.leaf_src for p in protos])
    acc_seq, acc_pid = flat_of([p.load_seqs + p.store_seqs for p in protos])
    if len(protos) >= 2 ** 22 or (
            len(acc_seq) and int(ct.addr[acc_seq].max()) // 64
            >= 2 ** _LINE_BITS):
        raise ValueError("placement key (proto, line) exceeds int64")
    first_load = torch.tensor([p.load_seqs[0] if p.load_seqs else 0
                               for p in protos], dtype=torch.int64).to(dev)
    flat = memo[key] = (leaf_seq, leaf_pid, acc_seq, acc_pid, first_load)
    return flat


def place_candidates(part, ct, cfg) -> List:
    """``_place`` on the trace's device through the segment kernels."""
    from repro_torch.core.offload import _LEVEL_DEPTH, _candidates

    protos = part.protos
    if not protos:
        return []
    leaf_seq, leaf_pid, acc_seq, acc_pid, first_load = \
        _flat_arrays(part, ct, cfg)
    n_seg = len(protos)
    dev = ct.device
    depth_cap = max(_LEVEL_DEPTH[l] for l in cfg.cim_levels)
    enabled = torch.tensor(sorted(_LEVEL_DEPTH[l] for l in cfg.cim_levels),
                           dtype=torch.int32, device=dev)

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

    target, moves, fills, banks = torch.stack(
        [target, moves, fills, ct.bank[first_load].to(torch.int32)]).tolist()
    return _candidates(protos, target, moves, fills, banks)
