"""Design points priced per second: every point of the window's whole
units over the window, overrun included (host clock)."""
from cimbench.yardstick import rate


def read(run):
    return rate(run.n_points, run.window_s)
