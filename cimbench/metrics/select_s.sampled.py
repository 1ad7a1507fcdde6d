"""Seconds of per-window Algorithm 1 (spans ``sampling.select``) per
sampled analysis (traced run)."""
from cimbench.layer import span_s_per_point


def read(run):
    return span_s_per_point(run, "sampling.select")
