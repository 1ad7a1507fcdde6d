"""Seconds from the start of the process to the start of the window:
imports, the kernels' build or load, the engine's set-up and warm-up."""


def read(run):
    return run.setup_s
