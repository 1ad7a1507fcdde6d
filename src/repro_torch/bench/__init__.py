"""Paper artifacts through the port (twin of the reference's
``benchmarks/`` package).

Each ``<artifact>.py`` here is the twin of ``benchmarks/<artifact>.py``
with the port's imports: the same rows, written as the same CSV and JSON
bytes.  The sweep artifacts (fig14–17, fig_adaptive) go through the
port's :class:`~repro_torch.dse.DSEEngine`; fig12/13 and table3/5/6 call
the core on the engine's memoized traces.  Run them with ``python -m
repro_torch.bench`` (:mod:`repro_torch.bench.run`).
"""
