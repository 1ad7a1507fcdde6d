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
  * :mod:`repro_torch.dse.backends` — the analyze → select → price split:
    the paper's CiM pipeline (:class:`CimBackend`, the default) and the
    accelerator-mode ATen-graph fusion pipeline (:class:`TpuBackend`)
    share the engine, cache, store, and reporting,
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

An accelerator-mode sweep is ``DSEEngine(backend=TpuBackend())`` over a
``SweepSpace(workloads=<arch ids>, tpus=...)``.  The DSE service is
:mod:`repro_torch.dse.service`.
A sampled sweep is ``DSEEngine(backend=CimBackend(sampling=spec))`` with
``SamplingSpec`` from :mod:`repro_torch.core.sampling`.
"""
from repro_torch.core.host_model import HOST_PRESETS
from repro_torch.core.tpu_model import TPU_PRESETS
from repro_torch.dse.adaptive import (AdaptiveDSE, AdaptiveResult,
                                      RoundEvent, RoundInfo, coarse_seed)
from repro_torch.dse.backends import (AnalysisBackend, CimBackend,
                                      TpuBackend, TpuSelection,
                                      TpuWorkloadAnalysis, arch_fingerprint)
from repro_torch.dse.engine import AnalysisCache, DSEEngine
from repro_torch.dse.pareto import (dominates, frontier_stable,
                                    objective_vector, pareto_front)
from repro_torch.dse.results import SweepRecord, SweepResults
from repro_torch.dse.space import (CACHE_PRESETS, CIM_SETS, LEVEL_PRESETS,
                                   CacheOption, HostOption, SweepPoint,
                                   SweepSpace, TpuOption, neighborhood,
                                   parse_bytes, tpu_neighbors)
from repro_torch.dse.store import (AnalysisStore, StoreFormatError,
                                   workload_fingerprint)

__all__ = [
    "AdaptiveDSE", "AdaptiveResult", "AnalysisBackend", "AnalysisCache",
    "AnalysisStore", "CimBackend", "DSEEngine", "RoundEvent", "RoundInfo",
    "StoreFormatError", "TpuBackend", "TpuSelection", "TpuWorkloadAnalysis",
    "arch_fingerprint", "coarse_seed",
    "dominates", "frontier_stable", "neighborhood", "objective_vector",
    "pareto_front", "parse_bytes", "tpu_neighbors", "SweepRecord",
    "SweepResults", "CACHE_PRESETS", "CIM_SETS", "HOST_PRESETS",
    "LEVEL_PRESETS", "TPU_PRESETS", "CacheOption", "HostOption",
    "SweepPoint", "SweepSpace", "TpuOption", "workload_fingerprint",
]
