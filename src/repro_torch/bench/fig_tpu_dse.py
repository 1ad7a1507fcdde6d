"""TPU-mode DSE: chip x fusion-threshold x workload sweep through DSEEngine.

Twin of ``benchmarks/fig_tpu_dse.py``: the Eva-CiM questions re-asked of
a model's train step — does it benefit from VMEM-resident fusion, on which
chip, at which aggressiveness?  One :class:`repro_torch.dse.SweepSpace`
over the arch registry's reduced train steps with a
:class:`repro_torch.dse.TpuOption` axis (every preset chip crossed with
every ``min_saved_bytes`` threshold), priced by
:class:`repro_torch.dse.TpuBackend` — one ATen-graph analysis per
workload on the configured device (asserted from the engine's cache
counters; with a warm ``--cache-dir`` store a repeat run does *zero*),
fusion selection once per (workload, threshold), roofline/energy pricing
per point.  Emits the full grid, the per-workload Pareto frontier, and a
markdown report in the output directory.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.dse import (DSEEngine, SweepSpace, TPU_PRESETS, TpuBackend,
                             TpuOption, parse_bytes)
from repro_torch.bench.common import banner, device, emit, out_dir

WORKLOADS = ("qwen1.5-0.5b", "gemma3-1b", "xlstm-125m", "hymba-1.5b")
CHIPS = ("v5e", "v4", "v5p")                 # capability order (adjacency)
THRESHOLDS = ("16K", "64K", "256K")
OBJECTIVES = ("energy_improvement", "speedup")


def space(workloads=WORKLOADS, chips=CHIPS,
          thresholds=THRESHOLDS) -> SweepSpace:
    # TpuOption.of gives unknown presets the curated "known: [...]" error
    tpus = [TpuOption(TpuOption.of(c).chip, parse_bytes(t))
            for c in chips for t in thresholds]
    return SweepSpace(workloads=tuple(workloads), tpus=tuple(tpus))


def run(workloads=WORKLOADS, chips=CHIPS, thresholds=THRESHOLDS,
        cache_dir=None, engine=None):
    eng = engine or DSEEngine(backend=TpuBackend(), store=cache_dir,
                              device=device())
    results = eng.run(space(workloads, chips, thresholds))
    st = results.stats

    # the tentpole guarantee, asserted: layer-1 graph analysis ran exactly
    # once per (workload, shape) — built here or loaded from a warm store,
    # never twice
    n_analyses = st["trace_builds"] + st.get("store_l1_hits", 0)
    assert n_analyses == len(workloads), (
        f"expected one graph analysis per workload "
        f"({len(workloads)}), got {n_analyses} ({st})")

    front = {(r.workload, r.cache, r.cim_set)
             for r in results.pareto(OBJECTIVES)}
    rows = []
    for r in results:
        rows.append({
            "workload": r.workload, "chip": r.cache, "threshold": r.cim_set,
            "tpu_macr": round(r.macr, 4),
            "energy_improvement": round(r.energy_improvement, 3),
            "speedup": round(r.speedup, 3),
            "bound_ms": round(r.cim_runtime_ms, 5),
            "n_candidates": r.n_candidates,
            "fused_ops": r.n_cim_ops,
            "pareto": (r.workload, r.cache, r.cim_set) in front,
        })
    return rows, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help="comma-separated arch ids "
                         "(repro_torch.configs.registry)")
    ap.add_argument("--chips", default=",".join(CHIPS),
                    help=f"comma-separated chip presets "
                         f"(known: {','.join(TPU_PRESETS)})")
    ap.add_argument("--thresholds", default=",".join(THRESHOLDS),
                    help="comma-separated fusion min_saved_bytes (e.g. "
                         "16K,64K,1M)")
    ap.add_argument("--cache-dir",
                    default=os.environ.get("EVA_CIM_CACHE_DIR") or None,
                    help="persistent AnalysisStore dir: a second run does "
                         "zero graph analyses")
    # the runner calls main() with no argv: parse pure defaults there, the
    # real command line only when __main__ passes it explicitly
    args = ap.parse_args(argv if argv is not None else [])

    workloads = tuple(args.workloads.split(","))
    chips = tuple(args.chips.split(","))
    thresholds = tuple(args.thresholds.split(","))
    banner(f"TPU-mode DSE: {len(chips)} chips x {len(thresholds)} "
           f"thresholds x {len(workloads)} workloads")
    rows, results = run(workloads, chips, thresholds, args.cache_dir)
    st = results.stats
    print(f"  {len(results)} design points, {st['trace_builds']} graph "
          f"analyses built ({st.get('store_l1_hits', 0)} store hits), "
          f"{results.elapsed_s:.1f}s")
    for r in rows:
        mark = " *" if r["pareto"] else "  "
        print(f" {mark}{r['workload']:16s} {r['chip']:5s} "
              f"{r['threshold']:8s} macr {r['tpu_macr']:.3f} "
              f"E {r['energy_improvement']:6.2f}x spd {r['speedup']:5.2f}x")
    print("  (* = on the per-workload Pareto frontier)")
    emit("fig_tpu_dse", rows)
    report = out_dir() / "fig_tpu_dse.md"
    report.write_text(results.to_markdown(
        columns=("workload", "cache", "cim_set", "macr",
                 "energy_improvement", "speedup"),
        pareto_objectives=OBJECTIVES))
    print(f"  [report] {report}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
