"""BENCH: statistical sampling — accuracy on the suite, speedup at scale.

Twin of ``benchmarks/bench_sampling.py``, on an explicit device: the same
gates, the same JSON schema (plus the device it ran on), the same
synthetic spec.  Two claims make sampled analysis trustworthy:

1. **Suite accuracy** — across the Table-IV kernel suite, pricing through
   ``SamplingSpec`` (phase and stratified modes, default knobs) must agree
   with the exact pipeline to within 2% relative error on energy
   improvement and MACR.  Registry-sized kernels fit inside
   ``interval * budget``, so the plan degenerates to full coverage and the
   agreement is exact (0.000%).

2. **Speedup at scale** — a loop-scaled synthetic workload (``KM@256``,
   ~7.6M virtual instructions) must price >= 10x faster through sampling
   than through the exact pipeline, and the structural skim must walk
   virtual instructions >= 10x faster than the full trace VM emits rows.
   The sampled-vs-exact error on the synthetic is recorded alongside.

On ``cuda`` the replays run on the replay kernel and the placements on
the placement kernel, exact and sampled alike; the trace VM, the skim and
the windowed pass run on the host::

    python -m repro_torch.bench sampling                  # cuda
    python -m repro_torch.bench sampling --device cpu --workloads NB,KM \\
        --synthetic KM@16 --json build/bench_torch/sampling.json
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Dict, List, Optional

from repro_torch.bench.common import DEFAULT_OUT, banner
from repro_torch.core.cache import L1_32K, L2_256K
from repro_torch.core.columnar import resolve_device
from repro_torch.core.offload import OffloadConfig, analyze_trace
from repro_torch.core.profiler import profile_system
from repro_torch.core.reshape import reshape
from repro_torch.core.sampling import (SamplingSpec, build_workload,
                                       sampled_report, skim_program)
from repro_torch.core.trace import (TraceLimits, attach_cache_results,
                                    trace_structural)

LEVELS = (L1_32K, L2_256K)
CFG = OffloadConfig()
LIMITS = TraceLimits(max_instructions=1 << 62)

SUITE_TOL = 0.02              # gate 1: suite relative error on EI and MACR
SPEEDUP_MIN = 10.0            # gate 2: sampled vs exact wall-clock
SKIM_RATE_MIN = 10.0          # gate 2b: skim rate vs full-trace row rate

#: the synthetic probe's sampling spec — larger windows + warmup than the
#: defaults, trading some speed for representative cache/register state
SYNTH_SPEC = dict(interval=32768, budget=16, warmup=32768)


def _exact(workload: str, device):
    fn, args = build_workload(workload)
    t0 = time.perf_counter()
    st = trace_structural(fn, *args, limits=LIMITS, device=device)
    t_trace = time.perf_counter() - t0
    tr = attach_cache_results(st, LEVELS, device=device)
    analysis = analyze_trace(tr)
    result = analysis.select(CFG)
    rep = profile_system(tr, offload=result,
                         reshaped=reshape(analysis.trace, result),
                         device=device)
    return rep, time.perf_counter() - t0, t_trace, st.columns.n


def _rel(est: float, ref: float) -> float:
    return abs(est - ref) / max(abs(ref), 1e-12)


def suite_accuracy(workloads: List[str], device) -> Dict:
    """Gate 1: sampled-vs-exact error per suite kernel, both modes."""
    rows = []
    worst = 0.0
    for wl in workloads:
        rep, _, _, _ = _exact(wl, device)
        row = {"workload": wl, "exact_ei": rep.energy_improvement,
               "exact_macr": rep.macr}
        for mode in ("phase", "stratified"):
            est = sampled_report(wl, SamplingSpec(mode=mode), LEVELS, CFG,
                                 device=device)
            e_ei = _rel(est.metrics["energy_improvement"],
                        rep.energy_improvement)
            e_macr = _rel(est.metrics["macr"], rep.macr)
            worst = max(worst, e_ei, e_macr)
            row[mode] = {"ei_err": round(e_ei, 6),
                         "macr_err": round(e_macr, 6),
                         "n_windows": est.n_windows,
                         "n_intervals": est.n_intervals,
                         "ei_ci": round(est.ci["energy_improvement"], 6)}
        rows.append(row)
        print(f"  {wl:8s} phase ei/macr err "
              f"{row['phase']['ei_err']:.4%}/{row['phase']['macr_err']:.4%}"
              f"  stratified {row['stratified']['ei_err']:.4%}/"
              f"{row['stratified']['macr_err']:.4%}", flush=True)
    return {"rows": rows, "worst_rel_err": round(worst, 6)}


def synthetic_speedup(workload: str, device) -> Dict:
    """Gate 2: wall-clock and skim-rate advantage on a >=10^6-instruction
    loop-scaled workload, with the sampled-vs-exact error recorded."""
    fn, args = build_workload(workload)
    t0 = time.perf_counter()
    skim = skim_program(fn, *args, interval=SYNTH_SPEC["interval"])
    t_skim = time.perf_counter() - t0
    skim_rate = skim.total_virtual / max(t_skim, 1e-9)

    rep, t_exact, t_trace, n_rows = _exact(workload, device)
    trace_rate = skim.total_virtual / max(t_trace, 1e-9)

    out = {"workload": workload, "virtual_instructions": skim.total_virtual,
           "exact_rows": int(n_rows),
           "exact_s": round(t_exact, 3), "trace_s": round(t_trace, 3),
           "skim_s": round(t_skim, 3), "skim_rate_per_s": int(skim_rate),
           "trace_rate_per_s": int(trace_rate),
           "skim_rate_x": round(skim_rate / trace_rate, 2),
           "spec": dict(SYNTH_SPEC), "modes": {}}
    for mode in ("phase", "stratified"):
        spec = SamplingSpec(mode=mode, **SYNTH_SPEC)
        t0 = time.perf_counter()
        est = sampled_report(workload, spec, LEVELS, CFG, device=device)
        t_s = time.perf_counter() - t0
        out["modes"][mode] = {
            "sampled_s": round(t_s, 3),
            "speedup_x": round(t_exact / t_s, 2),
            "n_windows": est.n_windows, "n_intervals": est.n_intervals,
            "ei_err": round(_rel(est.metrics["energy_improvement"],
                                 rep.energy_improvement), 6),
            "macr_err": round(_rel(est.metrics["macr"], rep.macr), 6),
            "ei_ci": round(est.ci["energy_improvement"], 6)}
        m = out["modes"][mode]
        print(f"  {mode:10s} {t_s:6.2f}s vs exact {t_exact:.2f}s "
              f"-> {m['speedup_x']:.1f}x  (ei err {m['ei_err']:.2%}, "
              f"macr err {m['macr_err']:.2%})", flush=True)
    print(f"  skim: {skim.total_virtual:,} virtual instrs at "
          f"{int(skim_rate):,}/s = {out['skim_rate_x']:.1f}x the "
          f"full-trace rate", flush=True)
    return out


def check(doc: Dict) -> List[str]:
    failures = []
    worst = doc["suite"]["worst_rel_err"]
    if worst > SUITE_TOL:
        failures.append(f"suite accuracy: worst relative error {worst:.4%} "
                        f"> {SUITE_TOL:.0%}")
    syn = doc["synthetic"]
    if syn["virtual_instructions"] < 1_000_000:
        failures.append(f"synthetic workload too small: "
                        f"{syn['virtual_instructions']:,} < 1,000,000 "
                        f"virtual instructions")
    best = max(m["speedup_x"] for m in syn["modes"].values())
    if best < SPEEDUP_MIN:
        failures.append(f"synthetic speedup {best:.1f}x < {SPEEDUP_MIN}x")
    if syn["skim_rate_x"] < SKIM_RATE_MIN:
        failures.append(f"skim rate {syn['skim_rate_x']:.1f}x full-trace "
                        f"rate < {SKIM_RATE_MIN}x")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench sampling",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where replay, selection and pricing run: cuda "
                         "(default) or cpu")
    ap.add_argument("--workloads", default=None,
                    help="comma-separated suite kernels for the accuracy "
                         "gate (default: the whole Table-IV registry)")
    ap.add_argument("--synthetic", default="KM@256",
                    help="loop-scaled 'name@scale' workload for the "
                         "speedup gate (>= 10^6 virtual instructions)")
    ap.add_argument("--json", default=str(DEFAULT_OUT / "sampling.json"))
    ap.add_argument("--no-check", action="store_true",
                    help="record only; skip the accuracy/speedup gates")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from repro_torch.workloads import WORKLOADS
    workloads = (args.workloads.split(",") if args.workloads
                 else sorted(WORKLOADS))

    banner("BENCH: statistical sampling — accuracy and speedup")
    print(f"[1/2] suite accuracy ({len(workloads)} kernels, "
          f"default SamplingSpec, device {device})", flush=True)
    t0 = time.perf_counter()
    suite = suite_accuracy(workloads, device)
    print(f"  worst relative error: {suite['worst_rel_err']:.4%}")
    print(f"[2/2] synthetic speedup ({args.synthetic})", flush=True)
    synthetic = synthetic_speedup(args.synthetic, device)
    doc = {"suite": suite, "synthetic": synthetic,
           "gates": {"suite_tol": SUITE_TOL, "speedup_min": SPEEDUP_MIN,
                     "skim_rate_min": SKIM_RATE_MIN},
           "elapsed_s": round(time.perf_counter() - t0, 1),
           "device": str(device)}
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=1))
        print(f"  [json] {args.json}")
    if not args.no_check:
        failures = check(doc)
        for f in failures:
            print(f"  FAIL: {f}")
        if failures:
            return 1
        print(f"  gates: suite err <= {SUITE_TOL:.0%}, speedup >= "
              f"{SPEEDUP_MIN:.0f}x, skim rate >= {SKIM_RATE_MIN:.0f}x "
              f"— all passed")
    return 0
