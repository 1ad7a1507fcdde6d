"""The reference's roofline rows on the dry-run records of the card's
sharded-path phase (``chip_smoke.py`` phase 14), committed because the
card's machine may have no jax.

``reference_roofline.json`` holds the records of :data:`PHASE_CELLS` as
``python -m repro_torch.launch.dryrun`` writes them, the reference's
``cell_roofline`` row of each and its ``markdown_table``.  Regenerate it
(needs jax; refuses when the port's rows differ) with
``PYTHONPATH=src python tests/test_torch_roofline.py --regenerate [DIR]``.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

ROOFLINE = (pathlib.Path(__file__).resolve().parent / "fixtures"
            / "reference_roofline.json")

#: (arch, shape, mesh) of each cell the card records at published widths
PHASE_CELLS = (
    ("gemma3-1b", "train_4k", "single"),
    ("gemma3-1b", "prefill_32k", "single"),
    ("gemma3-1b", "decode_32k", "single"),
    ("gemma3-1b", "long_500k", "single"),
    ("moonshot-v1-16b-a3b", "train_4k", "single"),
    ("yi-34b", "train_4k", "multi"),
)


def load_roofline() -> Dict[str, Any]:
    return json.loads(ROOFLINE.read_text())
