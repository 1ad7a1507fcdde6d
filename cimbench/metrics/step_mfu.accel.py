"""The window's train steps' matrix-product FLOPs, counted from the widths
and each step's routing (``cimbench/ref_accel/flops.py``), over the
device's busy time and the H100's 989 TFLOP/s dense bf16 peak, in %
(traced run)."""
from cimbench.accel_layer import step_mfu


def read(run):
    return step_mfu(run)
