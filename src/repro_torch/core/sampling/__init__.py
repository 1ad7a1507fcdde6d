"""Stratified interval sampling of trace analysis.

Twin of ``repro.core.sampling``, with the reference's ``__all__``.

Split a program's virtual instruction stream into fixed intervals, cluster
them by cheap structural features (SimPoint-style phases, or contiguous
strata), trace/replay/select/price only representative windows, and expand
back to whole-program metrics with bootstrap error bars.  See
:mod:`repro_torch.core.sampling.spec` for the knob set and
:mod:`repro_torch.core.sampling.estimate` for the estimator math.
"""
from repro_torch.core.sampling.cluster import SamplePlan, build_plan
from repro_torch.core.sampling.estimate import (SampledEstimate, estimate,
                                                estimate_reports,
                                                window_components)
from repro_torch.core.sampling.machines import (SamplingInterpreter,
                                                SkimMachine, SkimResult,
                                                WindowedMachine,
                                                WindowedTrace, skim_program,
                                                trace_windows)
from repro_torch.core.sampling.pipeline import (SampledAnalysis,
                                                SampledStructural,
                                                attach_sampled,
                                                build_workload,
                                                price_sampled,
                                                sampled_report,
                                                sampled_structural,
                                                select_sampled,
                                                slice_columns)
from repro_torch.core.sampling.spec import SAMPLING_VERSION, SamplingSpec

__all__ = [
    "SAMPLING_VERSION", "SamplingSpec", "SamplePlan", "build_plan",
    "SampledEstimate", "estimate", "estimate_reports", "window_components",
    "SamplingInterpreter", "SkimMachine", "SkimResult", "WindowedMachine",
    "WindowedTrace", "skim_program", "trace_windows",
    "SampledAnalysis", "SampledStructural", "attach_sampled",
    "build_workload", "price_sampled", "sampled_report",
    "sampled_structural", "select_sampled", "slice_columns",
]
