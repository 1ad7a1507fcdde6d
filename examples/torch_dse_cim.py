"""Design-space exploration with `repro_torch.dse` (the paper's §VI-D/E
questions), on the card.

Twin of ``examples/dse_cim.py``.  A sweep is a typed
cross-product over the paper's design axes (workload, cache geometry, CiM
level set, device technology, host CPU); the engine memoizes the
expensive trace/IDG analysis per (workload, cache) — one replay-kernel
launch per workload — and fans the pricing phase, with one
placement-kernel launch per selection, out over a worker pool::

    from repro_torch.dse import DSEEngine, SweepSpace

    space = SweepSpace(
        workloads=("KM", "BFS"),                 # Table IV programs
        caches=("32K+256K", "64K+256K", "64K+2M"),   # Fig. 14 axis
        cim_levels=("L1_only", "L2_only", "both"),   # Fig. 15 axis
        techs=("sram", "fefet"),                     # Fig. 16 axis
    )
    results = DSEEngine(device="cuda").run(space)   # 36 points, 6 analyses

Run this module for a guided tour over one workload::

    PYTHONPATH=src python examples/torch_dse_cim.py --workload KM
    PYTHONPATH=src python examples/torch_dse_cim.py --workload KM --device cpu
    PYTHONPATH=src python examples/torch_dse_cim.py --workload KM \\
        --report sweep.md --json sweep.json

``--cache-dir DIR`` persists every analysis artifact; a second invocation
with the same directory performs zero trace builds.  ``--hosts`` adds the
host-CPU axis (presets of ``repro_torch.core.host_model.HOST_PRESETS``),
``--adaptive`` swaps the cross-product for frontier-driven refinement,
``--sample MODE[:k=v,...]`` for statistical sampling, and ``--trace PATH``
/ ``--trace-report`` record the run's spans.  Every number it prints is
the reference's for the same arguments; one more line names the device
and the kernels' launches.

``--backend tpu`` runs the accelerator-mode pipeline instead: ``--workload``
is an arch id of ``repro_torch.configs.registry`` (default qwen1.5-0.5b),
whose reduced train step is recorded once as an ATen graph on the device,
and ``--chips`` / ``--thresholds`` span the chip presets and fusion
thresholds it is priced under::

    PYTHONPATH=src python examples/torch_dse_cim.py --backend tpu \\
        --workload gemma3-1b --chips v5e,v4,v5p --thresholds 16K,64K,256K
"""
import argparse
import sys

from repro_torch import obs
from repro_torch.core import accel
from repro_torch.core.sampling import SamplingSpec
from repro_torch.dse import (AdaptiveDSE, CimBackend, DSEEngine, HOST_PRESETS,
                             TPU_PRESETS, StoreFormatError, SweepSpace,
                             TpuBackend, TpuOption, parse_bytes)
from repro_torch.workloads import WORKLOADS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cim", choices=["cim", "tpu"],
                    help="analysis pipeline: the paper's CiM trace/IDG "
                         "path, or the accelerator-mode ATen-graph fusion "
                         "path")
    ap.add_argument("--workload", default=None,
                    help="CiM: a Table-IV program (default KM); TPU: an "
                         "arch id from repro_torch.configs.registry "
                         "(default qwen1.5-0.5b)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    ap.add_argument("--executor", default="thread",
                    choices=["thread", "process", "serial"])
    ap.add_argument("--cache-dir", default=None,
                    help="persistent AnalysisStore directory: repeated "
                         "invocations load artifacts instead of re-tracing")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated host presets to sweep "
                         f"(known: {','.join(HOST_PRESETS)}; CiM backend)")
    ap.add_argument("--chips", default=None,
                    help="comma-separated TPU chip presets "
                         f"(known: {','.join(TPU_PRESETS)}; TPU backend "
                         "only, default v5e,v4,v5p)")
    ap.add_argument("--thresholds", default=None,
                    help="comma-separated fusion min_saved_bytes values "
                         "(TPU backend only, default 16K,64K,256K)")
    ap.add_argument("--report", default=None,
                    help="write the markdown sweep report here")
    ap.add_argument("--json", default=None,
                    help="write structured sweep records here")
    ap.add_argument("--adaptive", action="store_true",
                    help="frontier-driven refinement instead of the "
                         "exhaustive cross-product (same frontier, fewer "
                         "points priced)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome "
                         "trace-event file here (open in ui.perfetto.dev)")
    ap.add_argument("--trace-report", action="store_true",
                    help="enable span tracing and print the per-stage "
                         "attribution table after the run")
    ap.add_argument("--sample", default=None, metavar="MODE[:k=v,...]",
                    help="statistical sampling instead of exact analysis "
                         "(CiM backend): 'stratified' or 'phase', with "
                         "optional knobs, e.g. "
                         "phase:interval=2048,budget=32. Sampled records "
                         "carry bootstrap CI columns, and --workload "
                         "accepts loop-scaled 'name@scale' variants")
    args = ap.parse_args(argv)

    # each backend owns some axes; mixing them is a mistake worth stopping
    # at the door rather than silently ignoring the flag (exit code 2)
    if args.backend == "tpu" and args.hosts is not None:
        ap.error("--hosts sweeps host CPUs, a CiM-backend axis; the TPU "
                 "pipeline has no host axis. Drop --hosts or use "
                 "--backend cim.")
    if args.backend == "tpu" and args.sample is not None:
        ap.error("--sample draws windows from the CiM instruction trace; "
                 "the TPU jaxpr/HLO pipeline has no trace to sample. Drop "
                 "--sample or use --backend cim.")
    if args.backend == "cim":
        tpu_only = [flag for flag, val in (("--chips", args.chips),
                                           ("--thresholds", args.thresholds))
                    if val is not None]
        if tpu_only:
            ap.error(f"{'/'.join(tpu_only)} select TPU chip presets and "
                     f"fusion thresholds, TPU-backend axes; the CiM "
                     f"pipeline sweeps caches/levels/techs instead. Drop "
                     f"{'/'.join(tpu_only)} or use --backend tpu.")


    args.tracing = bool(args.trace or args.trace_report)
    if args.tracing:
        # self-time attribution only telescopes to the run's wall-clock
        # when stages don't overlap; honor an explicit --executor, but
        # default a traced run to serial so the report sums to ~100%
        if "--executor" not in (argv if argv is not None else sys.argv[1:]):
            args.executor = "serial"
        obs.enable(obs.Tracer())

    if args.backend == "tpu":
        return _tpu_main(args)

    sampling = SamplingSpec()
    if args.sample:
        try:
            sampling = SamplingSpec.parse(args.sample)
        except ValueError as exc:
            ap.error(f"bad --sample: {exc}")
    args.workload = args.workload or "KM"
    base_workload = args.workload.partition("@")[0]
    if base_workload not in WORKLOADS:
        ap.error(f"unknown workload {args.workload!r}; "
                 f"known: {sorted(WORKLOADS)}")
    if "@" in args.workload and sampling.is_exact:
        ap.error(f"loop-scaled workload {args.workload!r} needs --sample "
                 f"(exact analysis only prices registry-sized workloads)")
    try:
        engine = DSEEngine(executor=args.executor, store=args.cache_dir,
                           backend=CimBackend(sampling=sampling),
                           device=args.device)
    except StoreFormatError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    hosts = tuple(args.hosts.split(",")) if args.hosts else (None,)
    space = SweepSpace(workloads=(args.workload,),
                       caches=("32K+256K", "64K+256K", "64K+2M"),
                       cim_levels=("L1_only", "L2_only", "both"),
                       techs=("sram", "fefet"),
                       hosts=hosts)
    print(f"== {args.workload}: {len(space)} design points, "
          f"{space.n_analyses()} trace analyses ==")
    if not sampling.is_exact:
        print(f"   sampling: {sampling.key()} "
              f"(metrics are estimates ± bootstrap CI)")
    before = accel.launch_counts()
    if args.adaptive:
        adaptive = AdaptiveDSE(space, engine=engine).run()
        for line in adaptive.summary().splitlines():
            print(f"   {line}")
        results = adaptive.results
    else:
        results = engine.run(space)
    st = results.stats
    print(f"   done in {results.elapsed_s:.1f}s "
          f"(trace builds {st.get('trace_builds')}, "
          f"selection builds {st.get('offload_builds')})")
    after = accel.launch_counts()
    launches = {k: after[k] - before[k] + engine.worker_launches[k]
                for k in ("replay", "place")}
    print(f"device: {engine.device} (replay kernel launches "
          f"{launches['replay']}, placement kernel launches "
          f"{launches['place']}; 0 on the CPU)")
    if args.cache_dir:
        print(f"   store: {st.get('store_l1_hits', 0)} trace hits / "
              f"{st.get('store_l2_hits', 0)} selection hits / "
              f"{st.get('store_writes', 0)} writes / "
              f"{st.get('store_corrupt_drops', 0)} corrupt drops "
              f"under {args.cache_dir}")
        _print_store_bytes(st)

    # the fixed Fig. 14/15/16 slices assume the full grid was priced —
    # an adaptive run skips dominated regions, so go straight to the front
    if args.adaptive:
        print("== Pareto frontier (identical to the exhaustive sweep's) ==")
        for r in adaptive.frontier:
            print(f"  {r.config_label:34s} E {r.energy_improvement:5.2f}x "
                  f"spd {r.speedup:5.2f}x  (round {r.round})")
        if args.report:
            with open(args.report, "w") as f:
                f.write(adaptive.to_markdown())
            print(f"[report] {args.report}")
        if args.json:
            results.to_json(args.json)
            print(f"[json] {args.json}")
        _finish_trace(args)
        return 0

    # the Fig. 14/15/16 slices fix the host axis at its first value
    host0 = results.records[0].host

    print(f"== cache-configuration slice (Fig. 14, CiM@L1+L2, SRAM) ==")
    for r in results:
        if r.cim_levels == "L1+L2" and r.tech == "sram" and r.host == host0:
            print(f"  {r.cache:10s} E-impr {r.energy_improvement:5.2f}x "
                  f"speedup {r.speedup:5.2f}x macr {r.macr:.3f}")

    print("== CiM level slice (Fig. 15, 32K+256K, SRAM) ==")
    for r in results:
        if r.cache == "32K+256K" and r.tech == "sram" and r.host == host0:
            print(f"  {r.cim_levels:6s} E-impr {r.energy_improvement:5.2f}x "
                  f"speedup {r.speedup:5.2f}x")

    print("== technology slice (Fig. 16, 32K+256K, CiM@L1+L2) ==")
    sram_base = next(r.base_energy_pj for r in results
                     if r.cache == "32K+256K" and r.cim_levels == "L1+L2"
                     and r.tech == "sram" and r.host == host0)
    for r in results:
        if (r.cache == "32K+256K" and r.cim_levels == "L1+L2"
                and r.host == host0):
            # paper normalizes to the SRAM non-CiM baseline
            print(f"  {r.tech:6s} E-impr vs SRAM-baseline "
                  f"{sram_base / r.cim_energy_pj:5.2f}x "
                  f"speedup {r.speedup:5.2f}x")

    if args.hosts:
        print("== host-model slice (32K+256K, CiM@L1+L2, SRAM) ==")
        for r in results:
            if (r.cache == "32K+256K" and r.cim_levels == "L1+L2"
                    and r.tech == "sram"):
                print(f"  {r.host:14s} E-impr {r.energy_improvement:5.2f}x "
                      f"speedup {r.speedup:5.2f}x")

    front = results.pareto(("energy_improvement", "speedup"))
    print(f"== Pareto frontier (energy improvement vs speedup) ==")
    for r in front:
        ci = (f" ±{r.energy_improvement_ci:.2f}" if r.sampling != "exact"
              else "")
        print(f"  {r.config_label:34s} E {r.energy_improvement:5.2f}x{ci} "
              f"spd {r.speedup:5.2f}x")

    if args.report:
        with open(args.report, "w") as f:
            f.write(results.to_markdown())
        print(f"[report] {args.report}")
    if args.json:
        results.to_json(args.json)
        print(f"[json] {args.json}")
    _finish_trace(args)
    return 0


def _finish_trace(args) -> None:
    """Export/report the run's spans (``--trace`` / ``--trace-report``)."""
    if not getattr(args, "tracing", False):
        return
    t = obs.tracer()
    if args.trace:
        n = t.export_chrome(args.trace)
        print(f"[trace] {args.trace}: {n} events "
              f"(load in ui.perfetto.dev)")
    if args.trace_report:
        print(obs.attribution_markdown(t.stage_attribution()))
    obs.disable()


def _print_store_bytes(st: dict) -> None:
    """Per-layer / per-backend on-disk footprint (AnalysisStore.stats())."""
    total = st.get("store_bytes_total")
    if not total:
        return
    def mb(n):
        return f"{n / 1e6:.2f} MB" if n >= 1e5 else f"{n / 1e3:.1f} KB"
    backends = ", ".join(
        f"{k.split('store_bytes_')[1]} {mb(v)}"
        for k, v in sorted(st.items())
        if k.startswith("store_bytes_")
        and k not in ("store_bytes_total", "store_bytes_layer1",
                      "store_bytes_layer2"))
    print(f"   store size: {mb(total)} on disk "
          f"(layer1 {mb(st.get('store_bytes_layer1', 0))} / "
          f"layer2 {mb(st.get('store_bytes_layer2', 0))}; {backends})")


def _tpu_main(args) -> int:
    """The accelerator-mode half of the CLI: same flags, same flow,
    TpuBackend, on ``--device``."""
    from repro_torch.configs.registry import ARCHS
    workload = args.workload or "qwen1.5-0.5b"
    if workload not in ARCHS:
        print(f"unknown arch {workload!r}; known: {sorted(ARCHS)}")
        return 1
    chips = tuple((args.chips or "v5e,v4,v5p").split(","))
    for c in chips:
        if c not in TPU_PRESETS:
            print(f"unknown TPU chip preset {c!r}; "
                  f"known: {sorted(TPU_PRESETS)}")
            return 1
    raw_thresholds = args.thresholds or "16K,64K,256K"
    try:
        thresholds = tuple(parse_bytes(t) for t in raw_thresholds.split(","))
    except ValueError:
        print(f"bad --thresholds {raw_thresholds!r}; expected "
              f"comma-separated byte counts like 16K,64K,1M")
        return 1
    tpus = [TpuOption(TPU_PRESETS[c], t) for c in chips for t in thresholds]
    try:
        engine = DSEEngine(executor=args.executor, store=args.cache_dir,
                           backend=TpuBackend(), device=args.device)
    except StoreFormatError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    space = SweepSpace(workloads=(workload,), tpus=tuple(tpus))
    print(f"== {workload}: {len(space)} design points, "
          f"1 ATen-graph analysis ==")
    if args.adaptive:
        adaptive = AdaptiveDSE(space, engine=engine).run()
        for line in adaptive.summary().splitlines():
            print(f"   {line}")
        results = adaptive.results
    else:
        results = engine.run(space)
    st = results.stats
    print(f"   done in {results.elapsed_s:.1f}s "
          f"(graph analyses {st.get('trace_builds')}, "
          f"fusion selections {st.get('offload_builds')})")
    print(f"device: {engine.device} (the train step's ATen graph is "
          f"recorded there; no kernel of the port is launched)")
    if args.cache_dir:
        print(f"   store: {st.get('store_l1_hits', 0)} analysis hits / "
              f"{st.get('store_writes', 0)} writes / "
              f"{st.get('store_corrupt_drops', 0)} corrupt drops "
              f"under {args.cache_dir}")
        _print_store_bytes(st)

    if not args.adaptive:
        chip0, thr0 = results.records[0].cache, results.records[0].cim_set
        print(f"== chip slice (threshold {thr0}) ==")
        for r in results:
            if r.cim_set == thr0:
                print(f"  {r.cache:6s} E-impr {r.energy_improvement:5.2f}x "
                      f"speedup {r.speedup:5.2f}x bound "
                      f"{r.cim_runtime_ms:.4f}ms")
        print(f"== fusion-threshold slice (chip {chip0}) ==")
        for r in results:
            if r.cache == chip0:
                print(f"  {r.cim_set:8s} tpu_macr {r.macr:.3f} "
                      f"E-impr {r.energy_improvement:5.2f}x "
                      f"speedup {r.speedup:5.2f}x")

    front = (adaptive.frontier if args.adaptive
             else results.pareto(("energy_improvement", "speedup")))
    print("== Pareto frontier (energy improvement vs speedup) ==")
    for r in front:
        print(f"  {r.workload}/{r.cache}/{r.cim_set:8s} "
              f"E {r.energy_improvement:5.2f}x spd {r.speedup:5.2f}x")

    if args.report:
        text = (adaptive.to_markdown() if args.adaptive
                else results.to_markdown(
                    columns=("workload", "cache", "cim_set", "macr",
                             "energy_improvement", "speedup")))
        with open(args.report, "w") as f:
            f.write(text)
        print(f"[report] {args.report}")
    if args.json:
        results.to_json(args.json)
        print(f"[json] {args.json}")
    _finish_trace(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
