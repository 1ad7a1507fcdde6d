"""Pricing's time off the CPU: wall-clock less thread CPU time
(``dur_ns - cpu_ns``) of the program's spans ``backend.price``, in ms per
design point of the window (thread-ms under the thread pool; traced
run)."""
from cimbench.spanread import wait_ms_per_point


def read(run):
    return wait_ms_per_point(run, "backend.price")
