"""repro_torch.dse — design-space exploration on the port (twin of
``repro.dse``).

The paper's headline use-case (§VI-D/E) is sweeping cache configurations,
CiM levels, and device technologies to locate the designs with the best
energy/performance trade-off:

  * :mod:`repro_torch.dse.space`   — typed sweep specification (the
    reference's axes, presets, enumeration order, labels and keys),
  * :mod:`repro_torch.dse.engine`  — executor with a layered analysis cache
    on an explicit device (one batched replay per workload, selection once
    per offload config, pricing per point) and thread/process fan-out,
  * :mod:`repro_torch.dse.backends` — the analyze → select → price split,
    with the paper's CiM pipeline (:class:`CimBackend`),
  * :mod:`repro_torch.dse.store`   — persistent content-addressed artifact
    store, in its own namespace beside the reference's,
  * :mod:`repro_torch.dse.results` — structured records, JSON/markdown
    reports, byte for byte the reference's,
  * :mod:`repro_torch.dse.pareto`  — Pareto-frontier extraction,
  * :mod:`repro_torch.dse.adaptive` — frontier-driven iterative refinement.

Quickstart::

    from repro_torch.dse import DSEEngine, SweepSpace

    space = SweepSpace(workloads=("KM", "BFS"),
                       caches=("32K+256K", "64K+2M"),
                       cim_levels=("L1_only", "both"),
                       techs=("sram", "fefet"),
                       hosts=("A9-1GHz", "inorder-1GHz"))
    results = DSEEngine(device="cuda").run(space)   # or device="cpu"
    print(results.best("energy_improvement", workload="KM").config_label)

Names of ``repro.dse`` that wait for a later slice (ROADMAP Queue 1):
``TpuBackend``, ``TpuSelection``, ``TpuWorkloadAnalysis`` and
``arch_fingerprint``, with the space's ``tpus`` axis, ``TPU_PRESETS``,
``TpuOption``, ``tpu_neighbors`` and ``parse_bytes`` (item 8, the
GPU-mode backend); the sampled pipeline behind ``CimBackend(sampling=...)``
(item 6); the DSE service ``repro.dse.service`` (item 7).
"""
from repro_torch.core.host_model import HOST_PRESETS
from repro_torch.dse.adaptive import (AdaptiveDSE, AdaptiveResult,
                                      RoundEvent, RoundInfo, coarse_seed)
from repro_torch.dse.backends import AnalysisBackend, CimBackend
from repro_torch.dse.engine import AnalysisCache, DSEEngine
from repro_torch.dse.pareto import (dominates, frontier_stable,
                                    objective_vector, pareto_front)
from repro_torch.dse.results import SweepRecord, SweepResults
from repro_torch.dse.space import (CACHE_PRESETS, CIM_SETS, LEVEL_PRESETS,
                                   CacheOption, HostOption, SweepPoint,
                                   SweepSpace, neighborhood)
from repro_torch.dse.store import (AnalysisStore, StoreFormatError,
                                   workload_fingerprint)

__all__ = [
    "AdaptiveDSE", "AdaptiveResult", "AnalysisBackend", "AnalysisCache",
    "AnalysisStore", "CimBackend", "DSEEngine", "RoundEvent", "RoundInfo",
    "StoreFormatError", "coarse_seed",
    "dominates", "frontier_stable", "neighborhood", "objective_vector",
    "pareto_front", "SweepRecord", "SweepResults", "CACHE_PRESETS",
    "CIM_SETS", "HOST_PRESETS", "LEVEL_PRESETS", "CacheOption",
    "HostOption", "SweepPoint", "SweepSpace", "workload_fingerprint",
]
