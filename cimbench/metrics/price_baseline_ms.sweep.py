"""Baseline pricing: the duration of the program's spans
``price.baseline``, in ms per design point of the window (thread-ms
under the thread pool; traced run)."""
from cimbench.spanread import span_ms_per_point


def read(run):
    return span_ms_per_point(run, "price.baseline")
