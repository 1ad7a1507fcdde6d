"""Self time of the spans ``model.mamba`` (the Mamba-2 mixers, forward and
remat recomputation), in ms per analysis (traced run)."""
from cimbench.accel_layer import self_ms_per_analysis


def read(run):
    return self_ms_per_analysis(run, "model.mamba")
