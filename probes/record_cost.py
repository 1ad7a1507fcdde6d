"""Host cost per recorded ATen op of the accelerator-mode backend's train
step: the step run with no mode, under a dispatch mode that does nothing,
and under ``repro_torch.core.hlo.GraphRecorder``.

    python3 probes/record_cost.py [--config granite-4.0-h-small-ep8]
        [--batch 1] [--seq-len 8192] [--device cuda] [--repeats 2]
        [--src DIR] [--out chiprun_out/record_cost.json]

``--config`` is a configuration name (a published one, or a reduced arch
id) or a benchmark configuration file (``cimbench/configs/*.json``).  The
step is made as ``repro_torch.dse.backends.record_train_step`` makes it
(weights and a uniform batch from a generator seeded with 0), run once to
warm up, then ``--repeats`` times in each mode, in turns; every run ends
in a device synchronise.  For each mode the probe prints the seconds of
each run and the median in microseconds per eqn of the recorded graph;
the recorder's line adds the time ``graph()`` takes, the eqn count and
its ``fallback_eqns`` (absent from older recorders).  ``--src`` imports
``repro_torch`` from another checkout's ``src`` (to time a parent commit
with the same probe).  Output: stdout and ``--out``.
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = pathlib.Path(__file__).resolve().parents[1]


class BareMode(TorchDispatchMode):
    """A dispatch mode that runs each op and does nothing else: the floor
    under any recorder."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def load_config(name: str):
    from repro_torch.dse import backends
    if name.endswith(".json"):
        sys.path.insert(0, str(ROOT))
        from cimbench.accel_port import program_config
        return program_config(json.loads(pathlib.Path(name).read_text()))
    return backends.model_config(name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="granite-4.0-h-small-ep8")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                          / "record_cost.json"))
    a = ap.parse_args()
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to time the host CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, a.src)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.hlo import GraphRecorder
    from repro_torch.models import inputs as minputs
    from repro_torch.train import steps as steps_mod

    cfg = load_config(a.config)
    dev = torch.device(a.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_train_state(gen, cfg, device=dev)
    data = minputs.make_train_batch(gen, cfg, batch=a.batch,
                                    seq_len=a.seq_len, device=dev)
    step = steps_mod.make_train_step(cfg, TrainConfig())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(mode):
        sync()
        t0 = time.perf_counter()
        if mode is None:
            out = step(state, data)
        else:
            with mode:
                out = step(state, data)
        sync()
        del out
        return time.perf_counter() - t0

    run(None)                                          # warm-up
    runs = {"none": [], "bare": [], "recorder": []}
    build_s, n_eqns, fallback = [], None, None
    for _ in range(a.repeats):
        runs["none"].append(run(None))
        runs["bare"].append(run(BareMode()))
        rec = GraphRecorder()
        runs["recorder"].append(run(rec))
        t0 = time.perf_counter()
        graph = rec.graph()
        build_s.append(time.perf_counter() - t0)
        n_eqns = len(graph.eqns)
        fallback = getattr(rec, "fallback_eqns", None)
        del rec, graph
    doc = {"config": cfg.arch_id, "batch": a.batch, "seq_len": a.seq_len,
           "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                      else "cpu"),
           "torch": torch.__version__, "src": a.src, "n_eqns": n_eqns,
           "fallback_eqns": fallback, "graph_s": build_s, "runs_s": runs,
           "us_per_eqn": {m: statistics.median(v) / n_eqns * 1e6
                          for m, v in runs.items()}}
    for m, v in runs.items():
        print(f"{m:9s} runs_s {v} us_per_eqn {doc['us_per_eqn'][m]:.3f}")
    print(f"graph() s {build_s} n_eqns {n_eqns} fallback_eqns {fallback}")
    out = pathlib.Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
