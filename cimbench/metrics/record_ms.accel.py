"""Wall time of the spans ``tpu.record`` (drawing the weights, the train
step run under the ATen-graph recorder), in ms per analysis (traced
run)."""
from cimbench.accel_layer import span_ms_per_analysis


def read(run):
    return span_ms_per_analysis(run, "tpu.record")
