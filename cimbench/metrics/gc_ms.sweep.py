"""The collector's pauses charged to the program's spans (their ``gc_ns``
attributes, summed over every span of the window), in ms per design
point (traced run)."""
from cimbench.spanread import gc_ms_per_point


def read(run):
    return gc_ms_per_point(run)
