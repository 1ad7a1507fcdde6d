"""The system under test: the port's DSE engine, driven by the units of
:mod:`cimbench.generator`, and read back after the window.

Only this module imports ``repro_torch``; it takes from it the engine,
its analysis cache, the sampled backend's artifacts, the obs spans and
the launch counters, and nothing of its arithmetic.  (The device trace,
:mod:`cimbench.devtrace`, reads the card through ``torch.profiler``.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import accel
from repro_torch.core.cache import CacheConfig
from repro_torch.core.host_model import HostModel
from repro_torch.core.sampling import SamplingSpec
from repro_torch.dse import (AnalysisCache, CimBackend, DSEEngine,
                             SweepPoint)
from repro_torch.dse.space import LEVEL_PRESETS, CacheOption, HostOption

from cimbench.ref.isa import OP_LOAD, OP_STORE
from cimbench.ref.pipeline import candidate_rows, reshaped_summary

MEM_OPS = (OP_LOAD, OP_STORE)


def levels(geometry, banks: int, mshrs: int) -> Tuple[CacheConfig, ...]:
    (l1k, l1w), (l2k, l2w) = geometry
    return (CacheConfig("L1", l1k * 1024, l1w, banks, mshrs),
            CacheConfig("L2", l2k * 1024, l2w, banks, mshrs))


def build_kernels() -> Dict[str, float]:
    """Compile the engine's CUDA libraries that the checkout's build
    directory lacks (the first run in a checkout); seconds per source."""
    from repro_torch.core.accel import _build
    return _build.build()


class Port:
    """One run's engine (or engines) on ``device``."""

    def __init__(self, traffic, config: Dict, device: str):
        self.traffic = traffic
        self.device = device
        self.banks, self.mshrs = config["banks"], config["mshrs"]
        self.virtual_instructions = config.get("virtual_instructions")
        self.cache: Optional[AnalysisCache] = None
        self.engine: Optional[DSEEngine] = None

    # ------------------------------------------------------------ points
    def cache_option(self, geometry) -> CacheOption:
        return CacheOption.of(levels(geometry, self.banks, self.mshrs))

    def sweep_point(self, p: Dict, index: int) -> SweepPoint:
        return SweepPoint(
            index=index, workload=p["workload"],
            cache=self.cache_option(p["geometry"]),
            cim_levels=LEVEL_PRESETS[p["cim_levels"]], tech=p["tech"],
            cim_set=p["cim_set"],
            host=(None if p["host"] is None
                  else HostOption.of(HostModel(**p["host"]))))

    def _backend(self, sampling: Optional[Dict]) -> CimBackend:
        if sampling is None:
            return CimBackend()
        return CimBackend(sampling=SamplingSpec(**sampling))

    def _new_engine(self, sampling: Optional[Dict] = None) -> DSEEngine:
        return DSEEngine(cache=self.cache, device=self.device,
                         backend=self._backend(sampling),
                         max_workers=self.traffic.params.get("workers"))

    # ------------------------------------------------------------ set-up
    def warm(self) -> int:
        """Price the mix's set-up points; returns how many."""
        kind = self.traffic.engine_kind
        if kind == "shared_cache":
            self.cache = AnalysisCache(device=self.device)
        pts = [self.sweep_point(p, i)
               for i, p in enumerate(self.traffic.warm_points())]
        sampling = self.traffic.warm_sampling()
        eng = self._new_engine(sampling)
        if kind == "shared":
            self.engine = eng
        eng.run(pts)
        return len(pts)

    # ------------------------------------------------------------ window
    def run_unit(self, unit: Dict) -> Dict:
        """Run one unit; returns what the check and the metrics read of
        it: the records as dicts, and the engines that hold its
        artifacts (one per sampled analysis)."""
        pts = unit["points"]
        if self.traffic.unit_kind == "request":
            rec = self.engine.evaluate(self.sweep_point(pts[0], 0))
            return {"records": [rec.to_dict()], "engines": [self.engine]}
        if "sampling" not in pts[0]:
            eng = self._new_engine()
            res = eng.run([self.sweep_point(p, i)
                           for i, p in enumerate(pts)])
            return {"records": [r.to_dict() for r in res.records],
                    "engines": [eng]}
        out = {"records": [], "engines": [], "work": 0}
        for p in pts:
            eng = self._new_engine(p["sampling"])
            (rec,) = eng.run([self.sweep_point(p, 0)]).records
            out["records"].append(rec.to_dict())
            out["engines"].append(eng)
            out["work"] += self.virtual_instructions
        return out

    def read_back(self, units: List[Dict]) -> None:
        """Once the window has closed: what each sampled analysis's skim
        counted (``virtual``) and its windowed stream's accesses, K1's
        work (``accesses``), from the analyses its engines memoized."""
        if self.traffic.params.get("sampling") is None:
            return
        for u in units:
            out = u["out"]
            out["virtual"], out["accesses"] = [], []
            for eng, p in zip(out["engines"], u["points"]):
                got = self.sampled(eng, p)
                if got is None:              # no analysis held: a miss
                    out["virtual"].append(-1)
                    out["accesses"].append(0)
                    continue
                ss = got[0].structural
                out["virtual"].append(int(ss.plan.total_virtual))
                out["accesses"].append(int(np.isin(ss.columns["col_op"],
                                                   MEM_OPS).sum()))

    def sampled(self, engine: DSEEngine, point: Dict):
        """The sampled analysis and per-window selections ``engine``
        memoized for ``point``; ``None`` if it holds none."""
        sp = self.sweep_point(point, 0)
        before = self._builds(engine)
        sa = engine.backend.analyze(engine.analysis, sp)
        selections = engine.backend.select(engine.analysis, sp, sa)
        if self._builds(engine) != before:
            return None
        return sa, selections

    # ------------------------------------------------------------ reading
    @staticmethod
    def _builds(engine: DSEEngine) -> Tuple[int, int]:
        s = engine.analysis.stats()
        return s["trace_builds"], s["offload_builds"]

    def layer1(self, engine: DSEEngine, workload: str, geometry
               ) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, int]]]:
        """The replay's per-access columns and counters that ``engine``
        holds for (workload, geometry); ``None`` if it holds none (a
        lookup that had to build is not what the window produced)."""
        before = self._builds(engine)
        tr = engine.analysis.trace(workload, self.cache_option(geometry))
        if self._builds(engine) != before:
            return None
        return self.mem_columns(tr), dict(tr.cache.counters())

    @staticmethod
    def mem_columns(tr) -> Dict[str, np.ndarray]:
        """A replayed trace's response columns over its memory rows."""
        t = tr.trace
        mem = t.mem_mask
        return {k: getattr(t, k)[mem].cpu().numpy()
                for k in ("level", "hit", "bank", "mshr")}

    @staticmethod
    def selection_rows(result, shaped) -> Tuple[List[tuple], tuple]:
        """A selection's candidates and reshaped summary, on the host."""
        host_seqs = torch.as_tensor(shaped.host_seqs).cpu().numpy()
        return (candidate_rows(result),
                reshaped_summary(dataclasses.replace(shaped,
                                                     host_seqs=host_seqs)))

    def selection(self, engine: DSEEngine, point: Dict
                  ) -> Optional[Tuple[List[tuple], tuple]]:
        """The candidates and reshaped summary ``engine`` holds for the
        point's selection; ``None`` if it holds none."""
        sp = self.sweep_point(point, 0)
        before = self._builds(engine)
        result, shaped = engine.analysis.offload(sp.workload, sp.cache,
                                                 sp.offload_config())
        if self._builds(engine) != before:
            return None
        return self.selection_rows(result, shaped)


    # ------------------------------------------------------------ the check
    def sample(self, units: List[Dict], ref, seed: int):
        """The outputs the check compares (:mod:`cimbench.check`)."""
        from cimbench import check
        if self.traffic.params.get("sampling") is not None:
            return check.take_sampled(self, units, seed,
                                      self.virtual_instructions)
        return check.take_sample(self, units, ref, seed,
                                 self.traffic.unit_kind)

    def k1_launches(self, units: List[Dict], spans: List[Dict], ref
                    ) -> List[Tuple[int, int]]:
        """``(accesses, geometries)`` of each replay-kernel launch of the
        window: one per sampled analysis, over its windowed stream; else
        from the replay spans that built (the accesses of a program from
        the reference's structural trace)."""
        if self.traffic.params.get("sampling") is not None:
            return [(n, 1) for u in units for n in u["out"]["accesses"]]
        out = []
        for s in spans:
            a = s["attrs"]
            if a.get("source") != "build":
                continue
            if s["name"] == "cache.replay_batch":
                n_geo = a["n_replayed"]
            elif s["name"] == "cache.trace":
                n_geo = 1
            else:
                continue
            st = ref.structural(a["workload"])
            out.append((int(st.columns.mem_mask.sum()), n_geo))
        return out


def start_tracing():
    """Turn the program's span tracer on; returns it."""
    return obs.enable()


def stop_tracing(tracer) -> List[Dict]:
    """The finished spans, with the tracer turned off; raises if it
    dropped any."""
    spans, dropped = tracer.spans(), tracer.dropped
    obs.disable()
    if dropped:
        raise RuntimeError(f"the tracer dropped {dropped} spans")
    return spans


def launch_counts() -> Dict[str, int]:
    return accel.launch_counts()


def synchronize(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()
