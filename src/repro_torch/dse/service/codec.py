"""Wire codec: JSON request bodies ⇄ typed sweep objects.

Twin of ``repro/dse/service/codec.py``, onto the port's
:class:`~repro_torch.core.sampling.spec.SamplingSpec`,
:class:`~repro_torch.dse.results.SweepRecord`,
:class:`~repro_torch.dse.space.SweepSpace` and
:data:`repro_torch.workloads.WORKLOADS`.

One request document describes everything a sweep needs::

    {
      "backend": "cim",                    # or "tpu"
      "mode": "sweep",                     # or "adaptive"
      "workloads": ["KM", "BFS"],          # Table-IV names / arch ids
      "caches": ["32K+256K", "64K+2M"],    # presets (CiM axes)
      "cim_levels": ["L1_only", "both"],
      "techs": ["sram", "fefet"],
      "cim_sets": ["stt"],
      "hosts": ["A9-1GHz"],                # optional host axis
      "tpus": [{"chip": "v5e", "min_saved_bytes": "64K"}],   # TPU axis
      "sampling": "stratified",            # optional, CiM only
      "objectives": ["energy_improvement", "speedup"],       # adaptive
      "max_rounds": 8                                        # adaptive
    }

Unknown axis values fail *here*, as a :class:`RequestError` the server
maps to HTTP 400 with the offending field named — a daemon must reject a
bad query loudly, not price a silently-defaulted space.  Every check and
message is the reference's; validation reuses the port's registries
(:data:`repro_torch.workloads.WORKLOADS`, the arch registry, the
``SweepSpace`` preset tables), so CLI and service accept exactly the same
vocabulary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.sampling.spec import SamplingSpec
from repro_torch.core.tpu_model import TPU_PRESETS
from repro_torch.dse.results import SweepRecord
from repro_torch.dse.space import SweepSpace, TpuOption, parse_bytes

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


def _tpu_option(spec) -> TpuOption:
    if isinstance(spec, str):
        if spec not in TPU_PRESETS:
            raise RequestError(f"unknown TPU chip preset {spec!r}; "
                               f"known: {sorted(TPU_PRESETS)}")
        return TpuOption.of(spec)
    if not isinstance(spec, dict):
        raise RequestError("each 'tpus' entry must be a chip-preset string "
                           "or an object with a 'chip' field")
    chip = spec.get("chip")
    if chip not in TPU_PRESETS:
        raise RequestError(f"unknown TPU chip preset {chip!r}; "
                           f"known: {sorted(TPU_PRESETS)}")
    try:
        return TpuOption(
            chip=TPU_PRESETS[chip],
            min_saved_bytes=parse_bytes(spec.get("min_saved_bytes", 1 << 16)),
            vmem_scale=float(spec.get("vmem_scale", 1.0)),
            hbm_bw_scale=float(spec.get("hbm_bw_scale", 1.0)))
    except (TypeError, ValueError) as exc:
        raise RequestError(f"bad 'tpus' entry {spec!r}: {exc}") from exc


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
    # statistical sampling: "sampling" is either a SamplingSpec object
    # ({"mode": "phase", "interval": 2048, ...}) or the CLI string form
    # ("phase:interval=2048,budget=32"); CiM-only — the accelerator-mode
    # pipeline has no trace to sample
    sampling = SamplingSpec()
    if doc.get("sampling") is not None:
        if backend == "tpu":
            raise RequestError("'sampling' is meaningless with backend "
                               "'tpu'; the jaxpr/HLO analysis has no "
                               "instruction trace to sample")
        raw = doc["sampling"]
        try:
            sampling = (SamplingSpec.parse(raw) if isinstance(raw, str)
                        else SamplingSpec.from_dict(raw))
        except ValueError as exc:
            raise RequestError(f"bad 'sampling': {exc}") from exc

    workloads = _str_tuple(doc, "workloads")
    if workloads is None:
        raise RequestError("'workloads' is required")
    if backend == "cim":
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
    else:
        from repro_torch.configs.registry import ARCHS
        unknown = [w for w in workloads if w not in ARCHS]
        if unknown:
            raise RequestError(f"unknown arch(s) {unknown}; "
                               f"known: {sorted(ARCHS)}")

    # CiM-only axes on a TPU request (and vice versa) are rejected, not
    # ignored — mirrors the examples/dse_cim.py CLI contract
    cim_axes = [f for f in ("caches", "cim_levels", "techs", "cim_sets",
                            "hosts") if doc.get(f) is not None]
    if backend == "tpu" and cim_axes:
        raise RequestError(f"CiM-only axes {cim_axes} are meaningless with "
                           f"backend 'tpu'; use 'tpus' "
                           f"(chip/min_saved_bytes)")
    if backend == "cim" and doc.get("tpus") is not None:
        raise RequestError("'tpus' is meaningless with backend 'cim'; "
                           "use caches/cim_levels/techs/cim_sets/hosts")

    try:
        if backend == "tpu":
            tpus = doc.get("tpus") or ["v5e"]
            if not isinstance(tpus, (list, tuple)) or not tpus:
                raise RequestError("'tpus' must be a non-empty list")
            space = SweepSpace(
                workloads=workloads,
                tpus=tuple(_tpu_option(t) for t in tpus))
        else:
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
