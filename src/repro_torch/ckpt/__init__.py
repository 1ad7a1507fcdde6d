"""Atomic npz snapshots, async saves and auto-resume (port of
``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)
