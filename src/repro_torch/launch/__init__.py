"""Entry points of the model zoo (``python -m repro_torch.launch.serve``)."""
from __future__ import annotations

from typing import Dict


def reset_kernel_launches() -> None:
    """Set the launch count of every hand-written kernel to 0."""
    from repro_torch import kernels
    from repro_torch.core import accel
    accel.reset_launch_counts()
    kernels.reset_launch_counts()


def kernel_launches() -> Dict[str, int]:
    """Launches of every hand-written kernel (``core.accel`` and
    ``kernels``) since :func:`reset_kernel_launches`: what a driver reports,
    so a run in a process of its own shows which kernels its path took."""
    from repro_torch import kernels
    from repro_torch.core import accel
    return {**accel.launch_counts(), **kernels.launch_counts()}
