"""Assigned input-shape set (same four shapes for every LM arch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache / recurrent state of length ``seq_len``); ``train_4k`` lowers
``train_step``; ``prefill_32k`` lowers the prefill ``serve_step``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or 'skip:<reason>' for an (arch x shape) cell.

    long_500k needs a sub-quadratic context path (SSM / hybrid / sliding
    window); pure full-attention archs skip it (recorded in DESIGN.md).
    """
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return "skip:full-attention arch has no sub-quadratic 500k path"
    return "run"


def runnable_cells(cfg: ModelConfig):
    return [s for s in ALL_SHAPES if cell_status(cfg, s) == "run"]
