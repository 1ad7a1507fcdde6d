"""Hand-written CUDA kernels of the CiM modules, and their launches.

Twin of ``repro/kernels/``, the reference's Pallas kernels of the TPU
adaptation:

  cim_bitwise      bulk AND/OR/XOR/ADD/SUB (paper Table III's op set) and
                   the fused IDG subtree ``(x op1 y) op2 z``
  flash_attention  softmax(QK^T)V computed where the KV block lives
  mlstm_chunk      the xLSTM matrix-memory recurrence, chunkwise

``ops.py`` holds the public wrappers, with the reference's padding and
block logic; ``ref.py`` the plain oracles every kernel is held to.  As in
:mod:`repro_torch.core.accel`, the device of the tensors is the switch: a
CUDA tensor launches the kernel (``csrc/*.cu``, built by ``nvcc`` at
first use) or raises, a CPU tensor takes the kernel's plain version, its
oracle in ``ref.py``.

Each wrapper adds one to its kernel's count where it launches it, so a run
can show that its path went through the kernels.
"""
from __future__ import annotations

import pathlib
from typing import Dict

#: the kernels' CUDA sources, one ``.cu`` per wrapper module
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

#: the kernels this package launches
KERNELS = ("cim_bitwise", "cim_bitwise_fused", "flash_attention",
           "mlstm_chunkwise")

_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
