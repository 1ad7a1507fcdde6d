"""Eva-CiM core, ported: the per-design-point pipeline (paper Fig. 1).

    trace_structural (trace VM) -> attach_cache_results_batch (replay per
        geometry)
        -> select_candidates (IDG / flow, Algorithm 1) -> reshape
        -> profile_system (energy improvement, speedup, MACR)

Twin of ``repro.core``.  ``trace_structural`` / ``trace_program`` run a
torch program on the trace VM (:mod:`repro_torch.core.trace`).
"""
from repro_torch.core.cache import (CacheConfig, CacheHierarchy, L1_32K,
                                    L1_64K, L2_256K, L2_2M, SPM_1M)
from repro_torch.core.columnar import ColumnarTrace
from repro_torch.core.device_model import FEFET, SRAM, TECHS, TechModel
from repro_torch.core.host_model import DEFAULT_HOST, HostModel
from repro_torch.core.idg import (FlowIndex, IDGBuilder, IDGNode,
                                  build_flow_index, build_rut_iht)
from repro_torch.core.isa import (CIM_SET_FULL, CIM_SET_LOGIC, CIM_SET_STT,
                                  Inst, Trace)
from repro_torch.core.offload import (Candidate, OffloadConfig,
                                      OffloadResult, TraceAnalysis,
                                      analyze_trace, select_candidates)
from repro_torch.core.profiler import Profiler, SystemReport, profile_system
from repro_torch.core.reshape import ReshapedTrace, reshape
from repro_torch.core.trace import (Machine, StructuralTrace, TraceLimits,
                                    TraceResult, attach_cache_results,
                                    attach_cache_results_batch,
                                    trace_program, trace_structural)

__all__ = [
    "CacheConfig", "CacheHierarchy", "L1_32K", "L1_64K", "L2_256K", "L2_2M",
    "SPM_1M", "ColumnarTrace", "FEFET", "SRAM", "TECHS", "TechModel",
    "DEFAULT_HOST", "HostModel", "FlowIndex", "IDGBuilder", "IDGNode",
    "build_flow_index", "build_rut_iht", "CIM_SET_FULL", "CIM_SET_LOGIC",
    "CIM_SET_STT", "Inst", "Trace",
    "Candidate", "OffloadConfig", "OffloadResult", "TraceAnalysis",
    "analyze_trace", "select_candidates", "Profiler", "SystemReport",
    "profile_system", "ReshapedTrace", "reshape", "StructuralTrace",
    "TraceResult", "attach_cache_results", "attach_cache_results_batch",
    "Machine", "TraceLimits", "trace_program", "trace_structural",
]
