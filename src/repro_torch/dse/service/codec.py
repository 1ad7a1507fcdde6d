"""Wire codec: JSON request bodies ⇄ typed sweep objects.

Twin of ``repro/dse/service/codec.py``, onto the port's
:class:`~repro_torch.core.sampling.spec.SamplingSpec`,
:class:`~repro_torch.dse.results.SweepRecord`,
:class:`~repro_torch.dse.space.SweepSpace` and
:data:`repro_torch.workloads.WORKLOADS`.

One request document describes everything a sweep needs::

    {
      "backend": "cim",
      "mode": "sweep",                     # or "adaptive"
      "workloads": ["KM", "BFS"],          # Table-IV names (name@scale)
      "caches": ["32K+256K", "64K+2M"],    # presets (CiM axes)
      "cim_levels": ["L1_only", "both"],
      "techs": ["sram", "fefet"],
      "cim_sets": ["stt"],
      "hosts": ["A9-1GHz"],                # optional host axis
      "sampling": "stratified",            # optional, CiM only
      "objectives": ["energy_improvement", "speedup"],       # adaptive
      "max_rounds": 8                                        # adaptive
    }

Unknown axis values fail *here*, as a :class:`RequestError` the server
maps to HTTP 400 with the offending field named — a daemon must reject a
bad query loudly, not price a silently-defaulted space.  Every check and
message is the reference's, with one exception: the reference's
``"backend": "tpu"`` prices through its TPU-mode analysis backend, which
this package does not have yet, so such a request is refused here with a
400 that says so.  It is never priced as CiM.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.sampling.spec import SamplingSpec
from repro_torch.dse.results import SweepRecord
from repro_torch.dse.space import SweepSpace

VALID_BACKENDS = ("cim", "tpu")
VALID_MODES = ("sweep", "adaptive")


class RequestError(ValueError):
    """A malformed or out-of-vocabulary request (HTTP 400)."""


def _str_tuple(doc: Dict, field: str,
               default: Optional[Sequence[str]] = None
               ) -> Optional[Tuple[str, ...]]:
    value = doc.get(field, default)
    if value is None:
        return None
    if (not isinstance(value, (list, tuple)) or not value
            or not all(isinstance(v, str) for v in value)):
        raise RequestError(f"{field!r} must be a non-empty list of strings")
    return tuple(value)


def parse_request(doc: Dict) -> Dict:
    """Validated request: backend, mode, space, adaptive options.

    Returns ``{"backend": str, "mode": str, "space": SweepSpace,
    "objectives": tuple, "max_rounds": int, "sampling": SamplingSpec}``.
    """
    if not isinstance(doc, dict):
        raise RequestError("request body must be a JSON object")
    backend = doc.get("backend", "cim")
    if backend not in VALID_BACKENDS:
        raise RequestError(f"unknown backend {backend!r}; "
                           f"known: {list(VALID_BACKENDS)}")
    mode = doc.get("mode", "sweep")
    if mode not in VALID_MODES:
        raise RequestError(f"unknown mode {mode!r}; known: "
                           f"{list(VALID_MODES)}")
    if backend == "tpu":
        raise RequestError("backend 'tpu' needs the GPU-mode analysis "
                           "backend, which this package does not have yet; "
                           "only backend 'cim' is served")

    # statistical sampling: "sampling" is either a SamplingSpec object
    # ({"mode": "phase", "interval": 2048, ...}) or the CLI string form
    # ("phase:interval=2048,budget=32")
    sampling = SamplingSpec()
    if doc.get("sampling") is not None:
        raw = doc["sampling"]
        try:
            sampling = (SamplingSpec.parse(raw) if isinstance(raw, str)
                        else SamplingSpec.from_dict(raw))
        except ValueError as exc:
            raise RequestError(f"bad 'sampling': {exc}") from exc

    workloads = _str_tuple(doc, "workloads")
    if workloads is None:
        raise RequestError("'workloads' is required")
    from repro_torch.workloads import WORKLOADS
    unknown = [w for w in workloads if w.partition("@")[0]
               not in WORKLOADS]
    if unknown:
        raise RequestError(f"unknown workload(s) {unknown}; "
                           f"known: {sorted(WORKLOADS)}")
    scaled = [w for w in workloads if "@" in w]
    for w in scaled:
        tail = w.partition("@")[2]
        if not tail.isdigit() or int(tail) < 1:
            raise RequestError(f"bad workload scale in {w!r}; "
                               f"expected 'name@positive_int'")
    if scaled and sampling.is_exact:
        raise RequestError(
            f"loop-scaled workload(s) {scaled} ('name@scale') need "
            f"'sampling' — exact analysis only prices registry-sized "
            f"workloads")

    if doc.get("tpus") is not None:
        raise RequestError("'tpus' is meaningless with backend 'cim'; "
                           "use caches/cim_levels/techs/cim_sets/hosts")

    try:
        space = SweepSpace(
            workloads=workloads,
            caches=_str_tuple(doc, "caches") or ("32K+256K",),
            cim_levels=_str_tuple(doc, "cim_levels") or ("both",),
            techs=_str_tuple(doc, "techs") or ("sram",),
            cim_sets=_str_tuple(doc, "cim_sets") or ("stt",),
            hosts=_str_tuple(doc, "hosts") or (None,))
    except KeyError as exc:                    # unknown preset names
        raise RequestError(str(exc.args[0]) if exc.args else str(exc)) from exc

    objectives = _str_tuple(doc, "objectives",
                            ("energy_improvement", "speedup"))
    valid_metrics = {f.name for f in dataclasses.fields(SweepRecord)}
    bad = [o for o in objectives if o not in valid_metrics]
    if bad:
        raise RequestError(f"unknown objective(s) {bad}; objectives must be "
                           f"SweepRecord metric names")
    max_rounds = doc.get("max_rounds", 8)
    if not isinstance(max_rounds, int) or max_rounds < 0:
        raise RequestError("'max_rounds' must be a non-negative integer")

    return {"backend": backend, "mode": mode, "space": space,
            "objectives": objectives, "max_rounds": max_rounds,
            "sampling": sampling}


def records_json(records: Sequence[SweepRecord]) -> List[Dict]:
    """Records as strict-JSON dicts: non-finite floats become ``null``
    (``NaN`` is a Python-ism most JSON parsers reject, and a degenerate
    record must not poison a whole NDJSON stream)."""
    out = []
    for r in records:
        doc = r.to_dict()
        for k, v in doc.items():
            if isinstance(v, float) and not math.isfinite(v):
                doc[k] = None
        out.append(doc)
    return out
