"""Fault-tolerant training loop (port of ``repro.ft``)."""
from repro_torch.ft.manager import FaultTolerantRunner, StragglerMonitor
