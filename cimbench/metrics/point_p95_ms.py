"""95th percentile, over every request of the window, of one cold design
point's latency: from the call of ``DSEEngine.evaluate`` to its record,
device synchronised (host clock, ms)."""
from cimbench.yardstick import p95


def read(run):
    return p95([u["seconds"] for u in run.units]) * 1e3
