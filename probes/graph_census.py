"""Census of the accelerator-mode backend's recorded ATen graph, on the
host CPU and on the card, for two reduced archs.

    python3 probes/graph_census.py

Records each arch's reduced train step (B=2, S=32) with
``repro_torch.dse.backends.record_train_step`` on ``cpu`` and on ``cuda``
and prints the eqn counts, the ATen overloads one device has and the other
lacks, and the first position where the two sequences differ.  It shows
whether the graph (and so layer 1's eqns, candidates and bytes) depends on
the device or only on the torch version.  Output: stdout and
``chiprun_out/graph_census.json``.
"""
import collections
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: graph_census.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import reduced_config
    from repro_torch.dse.backends import record_train_step

    doc = {"torch": torch.__version__}
    for arch in ("qwen1.5-0.5b", "xlstm-125m"):
        graphs = {d: record_train_step(reduced_config(arch), 2, 32, d)
                  for d in ("cpu", "cuda")}
        ops = {d: collections.Counter(e.aten for e in g.eqns)
               for d, g in graphs.items()}
        first = next((i for i, (a, b) in enumerate(zip(
            graphs["cpu"].eqns, graphs["cuda"].eqns)) if a.aten != b.aten),
            None)
        doc[arch] = {"eqns": {d: len(g.eqns) for d, g in graphs.items()},
                     "cuda_only": dict(ops["cuda"] - ops["cpu"]),
                     "cpu_only": dict(ops["cpu"] - ops["cuda"]),
                     "first_difference": first}
        print(arch, json.dumps(doc[arch]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "graph_census.json").write_text(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
