"""Algorithm 1's tree extraction: the duration of the program's spans
``select.candidates`` less that of their ``select.place`` children, in ms
per design point of the window (traced run)."""
from cimbench.spanread import span_ms_per_point


def read(run):
    return span_ms_per_point(run, "select.candidates",
                             less="select.place")
