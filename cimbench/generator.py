"""The CiM kind's traffic generator (:mod:`cimbench.kinds.cim`): units of
work drawn from a mix's parameters and the run's seed.

A mix of a CiM cell is a JSON file, ``cimbench/traffic/<mix>.json``;
this module alone reads it.  Its keys:

``unit``
    ``"pass"``: a unit is a set of design points priced by one
    ``DSEEngine.run``; ``"request"``: a unit is one point priced by one
    ``DSEEngine.evaluate``.
``engine``
    ``"per_unit"``: a new engine, with a new analysis cache, for every
    unit, so nothing is reused across units; ``"shared_cache"``: a new
    engine per unit over one analysis cache that set-up warms;
    ``"shared"``: one engine for the run, warmed in set-up.
``workers``
    optional: the size of a pass engine's thread pool (the engine's
    default, one thread per core up to 8, where absent or ``null``).
``draw``
    ``"cross"``: a unit is the cross product of the axes below, with
    ``geometry.per_unit`` geometries drawn anew for it; ``"one"``: a unit
    is one point, each axis drawn uniformly, and no (workload, geometry)
    pair drawn twice in a run.
``workloads``
    a list of program names, or ``"config"`` for the configuration's.
``geometry``
    ``{"fixed": [[l1_kib, l1_ways], [l2_kib, l2_ways]]}``, or the ranges
    ``l1_kib``, ``l1_ways``, ``l2_kib``, ``l2_ways`` and ``per_unit``: the
    geometries of a run are drawn from the ranges' product without
    repeats.
``cim_levels``, ``techs``, ``cim_sets``
    lists of level-set presets, technologies and CiM op sets.
``hosts``
    ``null`` (the configuration's host), or ``{"presets": [...]}``, with
    ``"ghz": [lo, hi]`` to re-clock each preset to a clock drawn per unit
    (:func:`cimbench.yardstick.scale_host_clock`).
``sampling``
    ``null`` (exact), or a sampling spec's fields.  With ``"seed":
    {"cycle": [...]}`` a unit analyses the program once per listed seed,
    in an order drawn per unit, each on an engine of its own: every unit
    does the same work, since the seed decides which windows are traced.
``warm``
    the set-up's points: the same axes as above, all fixed, priced once
    before the window on the engine (or cache) the window uses, or on a
    throw-away engine for ``"per_unit"``.

Everything drawn comes from ``random.Random`` seeded with the run's seed
and a stream name, so one seed gives one sequence of units.
"""
from __future__ import annotations

import itertools
import json
import pathlib
import random
from typing import Dict, Iterator, List, Optional, Tuple

from cimbench.ref.host_model import HOST_PRESETS
from cimbench.yardstick import scale_host_clock

Geometry = Tuple[Tuple[int, int], Tuple[int, int]]
UNITS = ("pass", "request")
ENGINES = ("per_unit", "shared_cache", "shared")
DRAWS = ("cross", "one")


def load(path) -> Dict:
    """A mix's parameters, checked."""
    params = json.loads(pathlib.Path(path).read_text())
    for key, allowed in (("unit", UNITS), ("engine", ENGINES),
                         ("draw", DRAWS)):
        if params.get(key) not in allowed:
            raise ValueError(f"{path}: {key} must be one of {allowed}, not "
                             f"{params.get(key)!r}")
    return params


def host_fields(preset: str) -> Dict:
    """A host preset's constants as keyword arguments of ``HostModel``."""
    model = HOST_PRESETS[preset]
    return {"pipeline_pj": model.pipeline_pj,
            "static_pj_per_cycle": model.static_pj_per_cycle,
            "unit_pj": dict(model.unit_pj), "base_cpi": model.base_cpi,
            "l2_stall": model.l2_stall, "mem_stall": model.mem_stall,
            "overlap": model.overlap, "cim_occupancy": model.cim_occupancy,
            "cim_overlap": model.cim_overlap, "name": model.name,
            "freq_ghz": model.freq_ghz}


def point(workload: str, geometry: Geometry, cim_levels: str, tech: str,
          cim_set: str, host: Optional[Dict] = None) -> Dict:
    """One design point as plain data: both the port's and the
    reference's objects are built from it."""
    return {"workload": workload,
            "geometry": [list(geometry[0]), list(geometry[1])],
            "cim_levels": cim_levels, "tech": tech, "cim_set": cim_set,
            "host": host}


class Traffic:
    """The units of one run of one cell."""

    def __init__(self, params: Dict, config: Dict, seed: int):
        self.params = params
        self.config = config
        self.seed = int(seed)
        wl = params["workloads"]
        self.workloads: List[str] = list(config["workloads"]
                                         if wl == "config" else wl)

    def _rng(self, stream: str) -> random.Random:
        return random.Random(f"{self.seed}:{stream}")

    @property
    def unit_kind(self) -> str:
        return self.params["unit"]

    @property
    def engine_kind(self) -> str:
        return self.params["engine"]

    def geometries(self) -> List[Geometry]:
        """Every geometry the mix may draw, in a fixed order."""
        g = self.params["geometry"]
        if "fixed" in g:
            (a, b), (c, d) = g["fixed"]
            return [((a, b), (c, d))]
        return [((l1k, l1w), (l2k, l2w)) for l1k, l1w, l2k, l2w in
                itertools.product(g["l1_kib"], g["l1_ways"], g["l2_kib"],
                                  g["l2_ways"])]

    def _hosts(self, rng: random.Random) -> List[Optional[Dict]]:
        h = self.params.get("hosts")
        if h is None:
            return [None]
        out = []
        for preset in h["presets"]:
            fields = host_fields(preset)
            if "ghz" in h:
                lo, hi = h["ghz"]
                fields = scale_host_clock(fields, rng.uniform(lo, hi))
            out.append(fields)
        return out

    def warm_points(self) -> List[Dict]:
        """The set-up's points."""
        w = self.params["warm"]
        wls = self.workloads if w.get("workloads", "config") == "config" \
            else w["workloads"]
        geos = [((a, b), (c, d)) for (a, b), (c, d) in w["geometries"]]
        return [point(*p) for p in itertools.product(
            wls, geos, w["cim_levels"], w["techs"], w["cim_sets"])]

    def warm_sampling(self) -> Optional[Dict]:
        """The set-up's sampling spec (``warm.sampling``), or ``None``."""
        return self.params["warm"].get("sampling")

    def units(self) -> Iterator[Dict]:
        """The run's units, in order, without end (a mix that draws
        geometries raises once it has used every one of its ranges)."""
        p = self.params
        rng = self._rng("units")
        if p["draw"] == "cross":
            pool = self.geometries()
            fixed = "fixed" in p["geometry"]
            k = 1 if fixed else p["geometry"]["per_unit"]
            if not fixed:
                rng.shuffle(pool)
            for index in itertools.count():
                if fixed:
                    geos = pool
                else:
                    geos = pool[index * k:(index + 1) * k]
                    if len(geos) < k:
                        raise RuntimeError("the mix has used every "
                                           "geometry of its ranges")
                hosts = self._hosts(rng)
                pts = [point(w, g, lv, t, cs, h) for w, g, lv, t, cs, h in
                       itertools.product(self.workloads, geos,
                                         p["cim_levels"], p["techs"],
                                         p["cim_sets"], hosts)]
                yield {"index": index, "points": self._sampled(pts, rng)}
        else:
            pairs = list(itertools.product(self.workloads,
                                           self.geometries()))
            rng.shuffle(pairs)
            for index, (w, g) in enumerate(pairs):
                lv = rng.choice(p["cim_levels"])
                t = rng.choice(p["techs"])
                cs = rng.choice(p["cim_sets"])
                (h,) = rng.sample(self._hosts(rng), 1)
                yield {"index": index,
                       "points": [point(w, g, lv, t, cs, h)]}
            raise RuntimeError("the mix has used every (workload, geometry) "
                               "pair")

    def _sampled(self, pts: List[Dict], rng: random.Random) -> List[Dict]:
        """The unit's points, each with the sampling spec it is analysed
        under (``"sampling"``, absent in an exact mix)."""
        spec = self.params.get("sampling")
        if spec is None:
            return pts
        seeds = spec["seed"]["cycle"] if isinstance(spec["seed"], dict) \
            else [spec["seed"]]
        seeds = rng.sample(seeds, len(seeds))
        return [dict(p, sampling=dict(spec, seed=s))
                for s in seeds for p in pts]
