"""Share of the traced window in which no operation ran on the device:
1 - (union of the device's events) / (window) (profiler trace)."""
from cimbench.layer import device_idle


def read(run):
    return device_idle(run)
