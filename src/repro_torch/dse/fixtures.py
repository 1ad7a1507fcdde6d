"""The reference's accelerator-mode DSE results that the port is held to
where JAX is absent (the card's machine).

``fixtures/reference_tpu_dse.json`` holds what ``repro.dse.TpuBackend``
computes for the workloads of ``fig_tpu_dse`` (which include ``ARCHS2``,
the two archs of the reference's backend tests): each layer-1
``TpuWorkloadAnalysis``, the 36 records and the Pareto front of
``fig_tpu_dse``'s grid, the 8 records of the reference's end-to-end test
space, and ``arch_fingerprint`` of the ten archs.
``tests/test_torch_backends.py --regenerate`` writes it.

:class:`RecordedTpuBackend` prices recorded analyses through the port's
own layers 2 and 3 (``_select`` and ``price``), so the records it gives
are the port's selection and pricing of the reference's analyses.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
from typing import Dict

from repro_torch.core.tpu_model import TPU_PRESETS
from repro_torch.dse.backends import (TpuBackend, TpuCandidate,
                                      TpuWorkloadAnalysis)
from repro_torch.dse.space import SweepSpace, TpuOption

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / \
    "reference_tpu_dse.json"
#: the two archs of the reference's backend tests
ARCHS2 = ("qwen1.5-0.5b", "xlstm-125m")
KB = 1 << 10


def end_to_end_space() -> SweepSpace:
    """The reference's ``test_tpu_sweep_end_to_end`` space: ARCHS2 x
    (v5e, v4) x (16K, 256K), 8 points."""
    tpus = [TpuOption(TPU_PRESETS[c], t)
            for c in ("v5e", "v4") for t in (16 * KB, 256 * KB)]
    return SweepSpace(workloads=ARCHS2, tpus=tuple(tpus))


@functools.lru_cache(maxsize=None)
def _doc() -> str:
    return FIXTURE.read_text()


def load() -> dict:
    """The fixture document (a fresh copy)."""
    return json.loads(_doc())


def analysis_from_dict(d: dict) -> TpuWorkloadAnalysis:
    """A ``TpuWorkloadAnalysis`` of the port from its field dict (as
    ``dataclasses.asdict`` gives it for either package)."""
    return TpuWorkloadAnalysis(**dict(
        d, candidates=tuple(TpuCandidate(**c) for c in d["candidates"])))


def analysis_dict(a) -> dict:
    """A ``TpuWorkloadAnalysis`` of either package as plain JSON values."""
    return json.loads(json.dumps(dataclasses.asdict(a)))


def reference_analyses() -> Dict[str, TpuWorkloadAnalysis]:
    return {w: analysis_from_dict(d) for w, d in load()["analyses"].items()}


@dataclasses.dataclass(frozen=True)
class RecordedTpuBackend(TpuBackend):
    """:class:`TpuBackend` whose layer 1 returns the fixture's (the
    reference's) analysis instead of recording a graph; selection and
    pricing are the port's."""

    def analyze(self, cache, point) -> TpuWorkloadAnalysis:
        # memo only: a recorded analysis never enters a persistent store
        return cache.artifact(
            1, ("tpu.recorded", point.workload, self.batch, self.seq_len),
            lambda: reference_analyses()[point.workload])
