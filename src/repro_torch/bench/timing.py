"""BENCH: per-stage analysis throughput over the fig14 workloads.

Twin of ``benchmarks/analysis_timing.py``, on an explicit device.  Times
every stage of the columnar trace -> IDG -> selection -> pricing pipeline
(instructions/second each), the end-to-end cold fig14-equivalent sweep on
a fresh :class:`~repro_torch.dse.DSEEngine`, and the persisted layer-1
footprint::

    python -m repro_torch.bench timing                      # cuda
    python -m repro_torch.bench timing --device cpu --workloads NB \\
        --json build/bench_torch/timing.json
    python -m repro_torch.bench timing --workloads NB \\
        --gate src/repro_torch/bench/baselines/timing_nb.json   # the gate

On ``cuda`` the replay runs on the replay kernel, the placement half of
selection on the placement kernel, and pricing's counts on the card; the
trace VM, the partition walk and the float sums run on the host.  Each
timed stage ends with its result on the host (and the card synchronised),
so a stage's seconds are the wall time a caller waits.  Before the timed
stages of each workload one untimed pass runs every stage on a copy of
its trace (the reference warms only its trace VM's jit oracles): on the
card the first call of each kernel in a process loads its module, a
start-up cost that no stage should carry.

The stages, ``calibrate()``, ``gate()`` and its messages, ``totals.share``
and ``dominant_stage``, the cold sweep, the layer-1 bytes and the Chrome
trace (``--trace``) are the reference's.  ``select_s`` is, as there, the
best of three selections with their reshape; ``reshape_s`` records the
reshape alone beside it.  Two things of the reference have no counterpart:

* ``select_jax`` -- the reference times its selection twice, through
  numpy and through its ``EVA_CIM_ACCEL=jax`` placement.  The port has
  one selection path and ``--device`` chooses where it runs, so
  :data:`GATE_STAGES` is ``("select", "price")``.
* ``BASELINE`` / ``improvement_x`` / ``shrink_x`` -- the reference's own
  pre-columnar history, measured on a CPU container; not the port's.

The doc records the device, and on ``cuda`` the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them, with the replay and placement
launches of the run.  ``--gate BASELINE`` compares the gated throughputs
with a committed doc; ``baselines/timing_nb.json`` was recorded by this
driver with ``--workloads NB`` on the card that the doc names.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.bench.common import DEFAULT_OUT, SWEEP_BENCHES, banner
from repro_torch.core import accel
from repro_torch.core.columnar import resolve_device

FIG14_CACHES = ("32K+256K", "64K+256K", "64K+2M")

# the gated stages: selection and pricing throughput may not drop more
# than this fraction below the calibration-scaled committed baseline
GATE_STAGES = ("select", "price")
GATE_THRESHOLD = 0.25


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _time(fn, device):
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _best_of(fn, device, repeats: int = 3):
    """Best-of-N wall time — the gated stages are fast enough that a single
    sample is scheduler noise; min-of-3 is what the gate compares."""
    out, best = None, float("inf")
    for _ in range(repeats):
        out, dt = _time(fn, device)
        best = min(best, dt)
    return out, best


def calibrate(repeats: int = 3) -> Dict:
    """Machine-speed score from a fixed numpy kernel.

    The kernel mirrors the columnar selection/pricing mix — sort, scan,
    masked reductions over a ~1M-element array — so its throughput tracks
    how fast *this* machine's host runs the gated stages.  Committed
    baselines store their score; the gate scales baseline throughput by
    ``score_now / score_then`` before comparing, making the 25% threshold
    portable across hosts.
    """
    import numpy as np
    rng = np.random.default_rng(12345)
    a = rng.standard_normal(1_000_000)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        s = np.sort(a)
        c = np.cumsum(s)
        m = (a > 0.0)
        _ = float(c[m[: c.size]].sum()) + float(np.count_nonzero(m))
        best = min(best, time.perf_counter() - t0)
    return {"kernel": "sort+cumsum+masked-reduce@1M",
            "score": round(1_000_000 / best / 1e6, 2)}   # M elements/s


def gate(doc: Dict, baseline: Dict,
         threshold: float = GATE_THRESHOLD) -> List[str]:
    """Compare a fresh timing doc against a committed baseline doc.

    Returns human-readable failure strings (empty == pass).  Only docs
    measured over the same workload set are comparable; anything else is
    itself a failure so CI can't silently gate against stale baselines.
    """
    failures: List[str] = []
    if list(baseline.get("workloads", [])) != list(doc["workloads"]):
        return [f"baseline workloads {baseline.get('workloads')} != "
                f"measured {doc['workloads']} — re-record the baseline"]
    base_cal = baseline.get("machine_calibration", {}).get("score")
    if not base_cal:
        return ["baseline has no machine_calibration score — re-record it "
                "with this version of repro_torch/bench/timing.py"]
    scale = doc["machine_calibration"]["score"] / base_cal
    for stage in GATE_STAGES:
        cur = doc["totals"].get(f"{stage}_ips")
        base = baseline["totals"].get(f"{stage}_ips")
        if not cur or not base:
            failures.append(f"{stage}: missing {stage}_ips in doc/baseline")
            continue
        floor = base * scale * (1.0 - threshold)
        if cur < floor:
            failures.append(
                f"{stage}: {cur:,.0f} inst/s < floor {floor:,.0f} "
                f"(baseline {base:,.0f} x calib {scale:.2f} x "
                f"{1.0 - threshold:.2f}) — "
                f"{(1 - cur / (base * scale)) * 100:.0f}% regression")
    return failures


def card(device) -> Optional[str]:
    """The card's ``name, power.limit`` as nvidia-smi prints them (None
    off the card)."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def run(workloads: Optional[Sequence[str]] = None,
        json_path: Optional[str] = None,
        trace_path: Optional[str] = None, device="cuda") -> Dict:
    from repro_torch.core.offload import OffloadConfig, analyze_trace
    from repro_torch.core.profiler import profile_system
    from repro_torch.core.reshape import reshape
    from repro_torch.core.trace import attach_cache_results, trace_structural
    from repro_torch.dse import (AnalysisCache, AnalysisStore, CacheOption,
                                 DSEEngine, SweepSpace)
    from repro_torch.dse.space import CACHE_PRESETS
    from repro_torch.workloads import build

    dev = resolve_device(device)
    workloads = tuple(workloads or SWEEP_BENCHES)
    full_set = workloads == tuple(SWEEP_BENCHES)
    cfg = OffloadConfig()
    launches_before = accel.launch_counts()

    # --trace records the run as a Chrome trace-event file; the per-stage
    # loops below call the analysis functions directly (few spans), but
    # the cold fig14 sweep exercises the fully instrumented engine path
    if trace_path:
        obs.enable(obs.Tracer())

    stages: Dict[str, Dict] = {}
    totals = {"n_instructions": 0, "trace_s": 0.0, "replay_s": 0.0,
              "idg_s": 0.0, "select_s": 0.0, "reshape_s": 0.0,
              "price_s": 0.0}
    for name in workloads:
        fn, args = build(name)
        # warm every stage once, on a trace of its own (a fresh memo)
        warm = attach_cache_results(trace_structural(fn, *args, device=dev),
                                    CACHE_PRESETS[FIG14_CACHES[0]],
                                    device=dev)
        warm_res = analyze_trace(warm).select(cfg)
        profile_system(warm, offload=warm_res,
                       reshaped=reshape(warm.trace, warm_res), device=dev)
        st, trace_s = _time(lambda: trace_structural(fn, *args, device=dev),
                            dev)
        n = st.n_instructions
        replay_s = 0.0
        trs = []
        for cname in FIG14_CACHES:
            tr, dt = _time(lambda: attach_cache_results(
                st, CACHE_PRESETS[cname], device=dev), dev)
            replay_s += dt
            trs.append(tr)
        an, idg_s = _time(lambda: analyze_trace(trs[0]), dev)
        (res, rs), select_s = _best_of(
            lambda: (lambda r: (r, reshape(trs[0].trace, r)))(
                an.select(cfg)), dev)
        _, reshape_s = _best_of(lambda: reshape(trs[0].trace, res), dev)
        rep, price_s = _best_of(lambda: profile_system(
            trs[0], offload=res, reshaped=rs, device=dev), dev)
        stages[name] = {
            "n_instructions": n,
            "trace_s": round(trace_s, 4),
            "trace_ips": round(n / trace_s),
            "replay_s_per_geometry": round(replay_s / len(FIG14_CACHES), 4),
            "idg_s": round(idg_s, 4),
            "idg_ips": round(n / idg_s) if idg_s else None,
            "select_s": round(select_s, 4),
            "select_ips": round(n / select_s) if select_s else None,
            "reshape_s": round(reshape_s, 4),
            "reshape_ips": round(n / reshape_s) if reshape_s else None,
            "price_s": round(price_s, 4),
            "price_ips": round(n / price_s) if price_s else None,
            "energy_improvement": round(rep.energy_improvement, 3),
        }
        totals["n_instructions"] += n
        totals["trace_s"] += trace_s
        totals["replay_s"] += replay_s
        totals["idg_s"] += idg_s
        totals["select_s"] += select_s
        totals["reshape_s"] += reshape_s
        totals["price_s"] += price_s
    for k in list(totals):
        if k.endswith("_s"):
            totals[k] = round(totals[k], 4)
    for stage in GATE_STAGES:       # aggregate throughput the gate compares
        dt = totals[f"{stage}_s"]
        totals[f"{stage}_ips"] = (round(totals["n_instructions"] / dt)
                                  if dt else None)
    # each stage's share of the pipeline (reshape is inside select), so
    # "X is the dominant stage" is generated from the measurement
    pipeline = ("trace", "replay", "idg", "select", "price")
    pipeline_s = sum(totals[f"{s}_s"] for s in pipeline)
    totals["pipeline_s"] = round(pipeline_s, 4)
    totals["share"] = {s: round(totals[f"{s}_s"] / pipeline_s, 3)
                       for s in pipeline} if pipeline_s else {}
    if totals["share"]:
        totals["dominant_stage"] = max(totals["share"],
                                       key=totals["share"].get)

    # ---- end-to-end: cold fig14-equivalent sweep (fresh engine) ---------
    space = SweepSpace(workloads=workloads, caches=FIG14_CACHES)
    eng = DSEEngine(device=dev)
    results, cold_s = _time(lambda: eng.run(space), dev)
    cold = {
        "points": len(results),
        "wall_s": round(cold_s, 3),
        "instructions_per_s": round(
            sum(r.n_instructions for r in results) / cold_s),
        "replay_batches": results.stats.get("replay_batches", 0),
    }

    # ---- persisted layer-1 footprint (.npz columns + flow) --------------
    with tempfile.TemporaryDirectory() as tmp:
        store = AnalysisStore(tmp)
        option = CacheOption.of("32K+256K")
        cache = AnalysisCache(store=store, device=dev)
        for name in workloads:
            cache.trace_analysis(name, option)
        usage = store.disk_usage()
    blob = {
        "layer1_bytes": usage["store_bytes_layer1"],
        "bytes_per_instruction": round(
            usage["store_bytes_layer1"] / max(1, totals["n_instructions"]),
            1),
    }

    after = accel.launch_counts()
    doc = {"workloads": list(workloads), "full_fig14_set": full_set,
           "device": str(dev), "card": card(dev),
           "machine_calibration": calibrate(),
           "stages": stages, "totals": totals, "cold_sweep": cold,
           "layer1_store": blob,
           "launches": {k: after[k] - launches_before[k]
                        for k in ("replay", "place")}}
    if trace_path:
        n_events = obs.tracer().export_chrome(trace_path)
        doc["trace"] = {"path": str(trace_path), "events": n_events}
        obs.disable()
    if json_path:
        path = pathlib.Path(json_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=1))
    return doc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench timing",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where replay, selection and pricing run: cuda "
                         "(default) or cpu")
    ap.add_argument("--workloads", default=None,
                    help="comma-separated workloads (default: the nine "
                         "fig13-15 sweep benchmarks)")
    ap.add_argument("--json", default=str(DEFAULT_OUT / "timing.json"))
    ap.add_argument("--gate", default=None, metavar="BASELINE",
                    help="fail if select/price throughput drops more than "
                         f"{GATE_THRESHOLD:.0%} below this committed doc")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run's spans as a Chrome trace here")
    args = ap.parse_args(argv)
    workloads = args.workloads.split(",") if args.workloads else None
    json_path, gate_path, trace_path = args.json, args.gate, args.trace

    banner("BENCH: columnar analysis pipeline throughput")
    doc = run(workloads=workloads, json_path=json_path,
              trace_path=trace_path, device=args.device)
    print(f"  device {doc['device']}"
          + (f" ({doc['card']})" if doc["card"] else "")
          + f": replay kernel launches {doc['launches']['replay']}, "
          f"placement kernel launches {doc['launches']['place']}")
    for name, s in doc["stages"].items():
        print(f"  {name:8s} n={s['n_instructions']:6d}  "
              f"trace {s['trace_ips']:>9,}/s  "
              f"idg {s['idg_ips']:>10,}/s  "
              f"select {s['select_ips']:>9,}/s  "
              f"reshape {s['reshape_ips']:>10,}/s  "
              f"price {s['price_ips']:>10,}/s")
    share = doc["totals"].get("share", {})
    if share:
        print("  stage shares: " + "  ".join(
            f"{s} {frac:.1%}" for s, frac in share.items())
            + f"  (dominant: {doc['totals']['dominant_stage']})")
    cold = doc["cold_sweep"]
    print(f"  cold sweep: {cold['points']} points in {cold['wall_s']}s "
          f"({cold['instructions_per_s']:,} inst/s, "
          f"{cold['replay_batches']} batched replays)")
    blob = doc["layer1_store"]
    print(f"  layer-1 store: {blob['layer1_bytes']:,} bytes "
          f"({blob['bytes_per_instruction']} B/inst)")
    if json_path:
        print(f"  [json] {json_path}")
    if trace_path:
        print(f"  [trace] {trace_path}: {doc['trace']['events']} events "
              f"(load in ui.perfetto.dev)")
    if gate_path:
        baseline = json.loads(pathlib.Path(gate_path).read_text())
        failures = gate(doc, baseline)
        doc["gate"] = {"baseline": str(gate_path),
                       "threshold": GATE_THRESHOLD,
                       "stages": list(GATE_STAGES),
                       "calibration_scale": round(
                           doc["machine_calibration"]["score"]
                           / baseline.get("machine_calibration",
                                          {}).get("score", 1) or 1, 3),
                       "failures": failures}
        if json_path:       # re-write with the verdict attached
            pathlib.Path(json_path).write_text(json.dumps(doc, indent=1))
        for f in failures:
            print(f"  GATE FAIL: {f}")
        if failures:
            return 1
        scale = doc["gate"]["calibration_scale"]
        print(f"  gate: {'+'.join(GATE_STAGES)} within "
              f"{GATE_THRESHOLD:.0%} of {gate_path} (calibration scale "
              f"x{scale}) — passed")
    return 0
