"""Millions of the program's virtual instructions analysed per second:
the completed sampled analyses' instructions (the configuration's count,
checked against each analysis's skim) over the window (host clock)."""
from cimbench.yardstick import rate


def read(run):
    return rate(sum(u["work"] for u in run.units), run.window_s) / 1e6
