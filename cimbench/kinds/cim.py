"""The CiM kind: Eva-CiM's question asked of programs.  A configuration
names Table-IV programs, the caches' banks and MSHRs, a host and, for a
sampled one, a sampling spec; a mix draws design points (geometries, CiM
level sets, technologies, CiM op sets, hosts) for the port's
``DSEEngine`` with its ``CimBackend``.

The pieces are the modules beside the kind: :mod:`cimbench.generator`
(the traffic), :mod:`cimbench.port` (the system under test),
:mod:`cimbench.check` (the comparison and its limits) and
:mod:`cimbench.ref` (the plain reference).  See :mod:`cimbench.kinds` for
what a kind gives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
from typing import Dict

import numpy as np

from cimbench import check, generator
from cimbench.ref.pipeline import Reference

HOME = pathlib.Path(__file__).resolve().parents[1]
LIMITS = check.LIMITS
compare = check.compare
#: the faults of a timed path: an answer altered where it is produced,
#: half of the batch left out, the replay's state never changed
FAULTS = ("answer", "half", "state")


def build_kernels() -> Dict[str, float]:
    from cimbench.port import build_kernels as build
    return build()


def traffic(path, config: Dict, seed: int) -> generator.Traffic:
    return generator.Traffic(generator.load(path), config, seed)


def port(traffic, config: Dict, device: str):
    from cimbench.port import Port
    return Port(traffic, config, device)


def keeps_every_unit(traffic: generator.Traffic) -> bool:
    """A pass's engine holds every artifact it built, so a window of
    cold passes keeps those of the last unit and of one drawn from all of
    them, and its heap does not grow; a sampled window runs few units,
    and keeps every one."""
    return not (traffic.engine_kind == "per_unit"
                and traffic.params.get("sampling") is None)


def reference(config: Dict) -> Reference:
    return Reference(config["banks"], config["mshrs"])


def control(sample: check.Sample, ref: Reference) -> Dict[str, float]:
    """The reference computed in float32, one precision below the
    configuration's float64 pricing, in the program's place."""
    return check.compare(sample, ref, float_type=np.float32, stand_in=True)


def _km16() -> Dict:
    doc = json.loads((HOME / "ref" / "sampled_windows.json").read_text())
    return doc["KM@16"]


def tiny_config(config: Dict) -> Dict:
    """Two Table-IV programs; KM@16 for a sampled configuration."""
    if config.get("sampling"):
        return dict(config, workloads=["KM@16"],
                    virtual_instructions=_km16()["total_virtual"])
    return dict(config, workloads=["NB", "SVM"])


def tiny_mix(mix: Dict) -> Dict:
    """A sampled mix at KM@16's spec with two of its seeds, warmed on
    KM@4 with 1024-instruction windows; any other mix as it is."""
    spec = mix.get("sampling")
    if not spec:
        return mix
    km16 = _km16()
    spec.update(interval=km16["spec"]["interval"],
                warmup=km16["spec"]["warmup"],
                seed={"cycle": sorted(map(int, km16["seeds"]))[:2]})
    mix["warm"]["workloads"] = ["KM@4"]
    mix["warm"]["sampling"].update(interval=1024, warmup=1024)
    return mix


@contextlib.contextmanager
def fault(name: str):
    """Break the program's timed path for the duration."""
    from repro_torch.core import cache as pcache
    from repro_torch.core.sampling import pipeline as spl
    from repro_torch.dse import backends, engine
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, obj.__dict__[attr]))
        setattr(obj, attr, value)

    if name == "answer":
        from_report = backends.SweepRecord.from_report.__func__
        from_estimate = backends.CimBackend._record_from_estimate

        def nudge(rec):
            return dataclasses.replace(
                rec, speedup=math.nextafter(rec.speedup, math.inf))

        patch(backends.SweepRecord, "from_report", classmethod(
            lambda cls, *a, **k: nudge(from_report(cls, *a, **k))))
        patch(backends.CimBackend, "_record_from_estimate",
              lambda self, *a, **k: nudge(from_estimate(self, *a, **k)))
    elif name == "half":
        run = engine.DSEEngine.run
        estimate_reports = spl.estimate_reports

        def half_run(self, space):
            pts = space.points() if hasattr(space, "points") else list(space)
            return run(self, pts[:max(1, len(pts) // 2)])

        def half_mean(reports, plan, spec):
            keep = list(reports[:max(1, len(reports) // 2)])
            return estimate_reports(
                [keep[i % len(keep)] for i in range(len(reports))],
                plan, spec)

        patch(engine.DSEEngine, "run", half_run)
        patch(spl, "estimate_reports", half_mean)
    elif name == "state":
        replay = pcache.CacheHierarchy.replay

        def unchanged(self, addrs, is_writes):
            lvl, hit, bank, mshr = replay(self, addrs, is_writes)
            return lvl.clone().fill_(lvl.max() if len(lvl) else 0), \
                hit.clone().fill_(0), bank, mshr

        patch(pcache.CacheHierarchy, "replay", unchanged)
    elif name != "none":
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
