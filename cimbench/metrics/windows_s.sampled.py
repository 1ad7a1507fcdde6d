"""Seconds of the windowed trace pass (spans ``sampling.windows``) per
sampled analysis (traced run)."""
from cimbench.layer import span_s_per_point


def read(run):
    return span_s_per_point(run, "sampling.windows")
