"""Replay kernel (K1): its bytes bound over the card's memory rate,
summed over its launches in the window, as a percentage of its device
time in the profiler's trace (traced run)."""
from cimbench.layer import k1_roofline


def read(run):
    return k1_roofline(run)
