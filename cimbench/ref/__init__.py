"""The plain NumPy reference of the exact per-design-point pipeline.

A copy of the original Eva-CiM package's NumPy path (``core/{isa, cache,
columnar, device_model, host_model, idg, offload, reshape, profiler}``),
imports retargeted to this package, the accelerator dispatch taken out,
and :mod:`cimbench.ref.trace` in place of the trace VM: the reference
starts from the committed structural traces under ``traces/``.  It
imports numpy alone, never torch, the port or JAX, so what the benchmark
checks the port against cannot move with the port.
"""
