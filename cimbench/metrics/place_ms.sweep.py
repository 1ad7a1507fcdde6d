"""Algorithm 1's placement (flat arrays, K4, readback, the join into
candidates): the duration of the program's spans ``select.place``, in ms
per design point of the window (traced run)."""
from cimbench.spanread import span_ms_per_point


def read(run):
    return span_ms_per_point(run, "select.place")
