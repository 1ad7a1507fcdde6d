"""What every kind reads of the program beside its own port: the span
tracer of ``repro_torch.obs``, the launch counters of
``repro_torch.core.accel`` and the device's queue.  Like a kind's port,
it takes nothing of the program's arithmetic.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def start_tracing():
    """Turn the program's span tracer on; returns it."""
    from repro_torch import obs
    return obs.enable()


def stop_tracing(tracer) -> List[Dict]:
    """The finished spans, with the tracer turned off; raises if it
    dropped any."""
    from repro_torch import obs
    spans, dropped = tracer.spans(), tracer.dropped
    obs.disable()
    if dropped:
        raise RuntimeError(f"the tracer dropped {dropped} spans")
    return spans


def launch_counts() -> Dict[str, int]:
    from repro_torch.core import accel
    return accel.launch_counts()


def synchronize(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()
