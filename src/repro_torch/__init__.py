"""PyTorch/CUDA port of the Eva-CiM reproduction (twin of ``repro``).

Module paths mirror the JAX package's: ``repro_torch.core.offload`` is the
port of ``repro.core.offload``.  The port imports torch and never JAX or
the ``repro`` package.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the card the analysis hot loops run as
hand-written CUDA kernels (:mod:`repro_torch.core.accel`), on the CPU as
their plain torch versions.
"""
