"""Self time of the program's spans of category ``trace``, in ms per design
point of the window (thread-seconds under the thread pool; traced run)."""
from cimbench.layer import self_ms_per_point


def read(run):
    return self_ms_per_point(run, "trace")
