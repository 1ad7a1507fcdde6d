"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output.

    python3 cimbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It exits with code 2, and prints no result, without a CUDA card or with
fewer cards than the cell asks for, and with code 3 if JAX or the
original package was loaded.  See ``cimbench/README.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _env() -> None:
    """Keep every compiler and kernel cache inside the checkout, at fixed
    paths, so only a checkout's first run builds."""
    cache = ROOT / "build" / "cimbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    from cimbench.manifest import Manifest
    chips = Manifest(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cimbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from cimbench.bench import run_cell
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_start=T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
