"""Hand-written CUDA kernels of the analysis hot loops, and their launches.

Twin of ``repro/core/accel/__init__.py``.  The reference chooses a backend
with ``EVA_CIM_ACCEL``; in the port the device of the tensors is the
switch.  A CUDA tensor goes through the kernel, a CPU tensor through the
kernel's plain version, and nothing in between: a wrapper given a CUDA
tensor launches its kernel or raises.

  * :mod:`.pallas_ops` -- ``segment_sum`` / ``segment_max`` (shared-memory
    and global atomics), which ``place.place_sorted`` composes; the
    pipeline's placement does not launch them
  * :mod:`.replay` -- the batched LRU/MSHR/writeback cache replay
  * :mod:`.place` -- placement (target level, moves, DRAM fills, bank per
    proto), one launch a call
  * :mod:`.price_counts` -- every count a design point is priced from,
    one launch and one readback a point

Launch accounting takes the place of the reference's ``jit_compiles``:
each wrapper adds one to its kernel's count where it launches it, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import threading
from typing import Dict

#: the kernels this package launches
KERNELS = ("segment_sum", "segment_max", "replay", "place", "price_counts")

_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# wrappers launch from the DSE engine's pool threads: a count is a
# read-modify-write, so it takes the lock
_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    with _lock:
        _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0
