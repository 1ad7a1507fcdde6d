"""Self time of the spans ``model.moe`` (router, dropless dispatch with
its readback, held and shared experts; forward and remat recomputation),
in ms per analysis (traced run)."""
from cimbench.accel_layer import self_ms_per_analysis


def read(run):
    return self_ms_per_analysis(run, "model.moe")
