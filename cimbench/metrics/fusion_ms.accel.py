"""Wall time of the spans ``tpu.fusion`` (``fusion_candidates`` over the
recorded graph), in ms per analysis (traced run)."""
from cimbench.accel_layer import span_ms_per_analysis


def read(run):
    return span_ms_per_analysis(run, "tpu.fusion")
