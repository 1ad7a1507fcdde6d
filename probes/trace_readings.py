"""One traced run of a ``cimbench`` cell, with what its result line does
not carry: the end-to-end metrics beside the per-layer ones, the span
count, the tracer's own readings (dropped spans, collector pauses with no
span open) and, per span name, the summed wall, thread CPU and collector
time.  Beside the benchmark's own per-layer metrics it reports those of
``cimbench/unlisted.json`` (readers built, not yet listed in
``BENCHMARK.json``) whose reader the checkout has.  It also reads the benchmark's collector probe (``GcPause``) for
the same window, so the pauses charged to spans can be held against it.

    python3 probes/trace_readings.py --workload exact-geometry \\
        --seed 2147480001 --seconds 51 [--root DIR] [--json PATH]

``--root`` runs the checkout at DIR (default: this one); ``--device cpu``
runs it on the host, for a try at a small size.  Prints one JSON line
last.
"""
import argparse
import collections
import json
import pathlib
import sys
import time

T_START = time.perf_counter()
HERE = pathlib.Path(__file__).resolve().parent.parent


def by_name(spans):
    """Per span name: count, and summed ``dur_ns``, ``cpu_ns`` (where
    recorded), ``gc_n`` and ``gc_ns``, in seconds where times."""
    out = collections.defaultdict(lambda: {"n": 0, "dur_s": 0.0,
                                           "cpu_s": 0.0, "gc_n": 0,
                                           "gc_s": 0.0})
    for s in spans:
        row = out[s["name"]]
        row["n"] += 1
        row["dur_s"] += s["dur_ns"] / 1e9
        row["cpu_s"] += s.get("cpu_ns", 0) / 1e9
        row["gc_n"] += s["attrs"].get("gc_n", 0)
        row["gc_s"] += s["attrs"].get("gc_ns", 0) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["dur_s"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path[:0] = [str(root)]
    from cimbench import run as cmd
    cmd.ROOT = root
    cmd._env()

    from cimbench import bench, port
    from cimbench.manifest import Manifest

    seen = {}
    stop_tracing = port.stop_tracing

    def stop(tracer):
        seen["dropped"] = tracer.dropped
        seen["gc_unattributed_n"] = getattr(tracer, "gc_unattributed_n",
                                            None)
        seen["gc_unattributed_s"] = getattr(tracer, "gc_unattributed_ns",
                                            0) / 1e9
        spans = stop_tracing(tracer)
        seen["n_spans"] = len(spans)
        seen["by_name"] = by_name(spans)
        return spans

    close = bench.GcPause.close

    def probe_close(self):
        seen["probe_gc_n"] = len(self.pauses)
        seen["probe_gc_s"] = sum(b - a for a, b in self.pauses) / 1e9
        close(self)

    metrics = Manifest.metrics
    unlisted = json.loads((HERE / "cimbench" / "unlisted.json").read_text())

    def with_end_to_end(self, cell, kind):
        got = metrics(self, cell, kind)
        if kind == "per_layer":
            got = metrics(self, cell, "end_to_end") + got + [
                m for m in unlisted["per_layer"]
                if cell in m["workloads"]
                and (self.home / "metrics" / f"{m['name']}.py").is_file()]
        return got

    port.stop_tracing = stop
    bench.GcPause.close = probe_close
    Manifest.metrics = with_end_to_end
    out = bench.run_cell(args.workload, args.seed, args.seconds, True,
                         root=root, device=args.device, t_start=T_START)
    out["readings"] = seen
    line = json.dumps(out)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
