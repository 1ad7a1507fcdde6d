"""Sampling configuration: the accuracy knob the whole stack learns.

Twin of ``repro/core/sampling/spec.py`` (pure Python; the port keeps its
own copy).  A :class:`SamplingSpec` travels from the CLI down through
:class:`~repro_torch.dse.backends.CimBackend` into the sampled analysis
pipeline (:mod:`repro_torch.core.sampling.pipeline`).  ``mode="exact"``
(the default) is the identity: every code path, cache key, and artifact
byte is the pre-sampling one.  The other two modes trade accuracy for
time:

``stratified``
    Contiguous equal strata over the interval index; ``budget`` windows
    sampled across strata proportionally.  No feature pass needed beyond
    the skim's virtual instruction count.

``phase``
    SimPoint-style phase detection: k-means over per-interval structural
    feature vectors (op mix + dependency-depth histogram) from the skim
    pass, one or more representative windows per phase.

``SAMPLING_VERSION`` stamps every persisted sampled artifact: bump it
whenever the estimator, the plan construction, or the sampled artifact
schema changes meaning — old sampled blobs become unreachable while exact
artifacts stay warm.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

SAMPLING_VERSION = 1

MODES = ("exact", "stratified", "phase")

# knob -> (attribute, parser) for the CLI / request "mode:k=v,..." syntax
_KNOBS = {
    "interval": int,
    "budget": int,
    "warmup": int,
    "seed": int,
    "target_ci": float,
    "confidence": float,
    "n_boot": int,
}


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """How (and whether) to sample a workload's trace.

    ==========  =========================================================
    knob        meaning
    ==========  =========================================================
    mode        ``exact`` | ``stratified`` | ``phase``
    interval    virtual instructions per interval (the sampling unit)
    budget      max sampled windows traced/replayed/priced per workload
    warmup      virtual instructions traced *before* each window to warm
                the register file and cache state (detailed warmup a la
                SMARTS); warmup rows are never priced
    seed        RNG seed: window picks, k-means init, bootstrap resamples
    target_ci   refine until the relative CI half-width of the energy
                estimate is below this (0 = one pass, no refinement)
    confidence  bootstrap percentile-interval confidence level
    n_boot      bootstrap resamples per estimate
    ==========  =========================================================

    Frozen + hashable: rides inside the frozen
    :class:`~repro_torch.dse.backends.CimBackend` across process-pool
    boundaries and into :class:`~repro_torch.dse.engine.AnalysisCache` memo
    keys.
    """
    mode: str = "exact"
    interval: int = 2048
    budget: int = 32
    warmup: int = 2048
    seed: int = 0
    target_ci: float = 0.0
    confidence: float = 0.95
    n_boot: int = 200

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown sampling mode {self.mode!r}; "
                             f"known: {MODES}")
        if self.interval < 64:
            raise ValueError("sampling interval must be >= 64 instructions")
        if self.budget < 1:
            raise ValueError("sampling budget must be >= 1 window")
        if self.warmup < 0:
            raise ValueError("warmup must be >= 0 instructions")
        if not 0.0 <= self.target_ci < 1.0:
            raise ValueError("target_ci must be in [0, 1)")
        if not 0.5 < self.confidence < 1.0:
            raise ValueError("confidence must be in (0.5, 1)")
        if self.n_boot < 10:
            raise ValueError("n_boot must be >= 10")

    @property
    def is_exact(self) -> bool:
        return self.mode == "exact"

    def key(self) -> str:
        """Compact identity string, used in cache/store keys and the
        ``sampling`` column of sampled :class:`~repro_torch.dse.results.SweepRecord`
        rows.  Exact mode has no key — exact artifacts must keep their
        pre-sampling cache identity."""
        if self.is_exact:
            return "exact"
        k = f"{self.mode}:i{self.interval}:b{self.budget}:s{self.seed}"
        if self.warmup != 2048:
            k += f":w{self.warmup}"
        if self.target_ci:
            k += f":t{self.target_ci:g}"
        if self.confidence != 0.95:
            k += f":c{self.confidence:g}"
        if self.n_boot != 200:
            k += f":r{self.n_boot}"
        return k

    # ------------------------------------------------------------- codecs
    @classmethod
    def parse(cls, text: str) -> "SamplingSpec":
        """CLI syntax: ``mode[:knob=value,...]``.

        e.g. ``--sample phase:interval=1024,budget=16,seed=3``
        """
        mode, _, rest = text.strip().partition(":")
        kwargs: Dict[str, object] = {"mode": mode or "exact"}
        if rest:
            for item in rest.split(","):
                name, sep, val = item.partition("=")
                if not sep or name not in _KNOBS:
                    raise ValueError(
                        f"bad sampling knob {item!r}; knobs: "
                        f"{sorted(_KNOBS)} (syntax: mode:k=v,k=v)")
                kwargs[name] = _KNOBS[name](val)
        return cls(**kwargs)

    @classmethod
    def from_dict(cls, doc: Dict) -> "SamplingSpec":
        """Service request codec: ``{"mode": ..., "interval": ..., ...}``."""
        if not isinstance(doc, dict):
            raise ValueError("'sampling' must be a JSON object")
        bad = [k for k in doc if k != "mode" and k not in _KNOBS]
        if bad:
            raise ValueError(f"unknown sampling knob(s) {bad}; knobs: "
                             f"['mode'] + {sorted(_KNOBS)}")
        kwargs: Dict[str, object] = {}
        if "mode" in doc:
            kwargs["mode"] = doc["mode"]
        for name, conv in _KNOBS.items():
            if name in doc:
                kwargs[name] = conv(doc[name])
        return cls(**kwargs)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)
