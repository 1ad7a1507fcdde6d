"""Paper-artifact runner of the port — one module per table/figure.

Twin of ``benchmarks/run.py``::

    python -m repro_torch.bench                      # every artifact, cuda
    python -m repro_torch.bench fig14 fig15          # some of them
    python -m repro_torch.bench --device cpu table6  # the plain versions
    python -m repro_torch.bench --out DIR fig17      # else build/bench_torch
    python -m repro_torch.bench --list               # enumerate artifacts
    python -m repro_torch.bench sampling [...]       # the sampling bench

Each artifact's CSV and JSON are byte for byte what ``python -m
benchmarks.run`` writes for the same name.  ``sampling`` is not an
artifact: it runs :mod:`repro_torch.bench.sampling` (the twin of
``benchmarks/bench_sampling.py``) with the arguments that follow it.
``analysis_timing``, ``tpu_macr``, ``fig_tpu_dse``, ``roofline`` and
``bench_service`` wait for ROADMAP Queue 1 items 3, 7 and 8.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.bench import (common, fig12_macr_validation, fig13_macr,
                               fig14_cache_cfg, fig15_levels, fig16_tech,
                               fig17_host, fig_adaptive, table3_energy,
                               table5_validation, table6_speedup)

ALL = {
    "table3": table3_energy,
    "table5": table5_validation,
    "fig12": fig12_macr_validation,
    "fig13": fig13_macr,
    "table6": table6_speedup,
    "fig14": fig14_cache_cfg,
    "fig15": fig15_levels,
    "fig16": fig16_tech,
    "fig17": fig17_host,
    "fig_adaptive": fig_adaptive,
}
#: the artifacts whose design space the engine sweeps (their drivers
#: expose ``space()``)
SWEEPS = tuple(name for name, mod in ALL.items() if hasattr(mod, "space"))


def stem(name: str) -> str:
    """File stem of artifact ``name``'s CSV and JSON: its driver's module
    name, as in ``benchmarks/``."""
    return ALL[name].__name__.rsplit(".", 1)[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    ap.add_argument("--out", default=str(common.DEFAULT_OUT),
                    help="directory of the CSV/JSON artifacts")
    ap.add_argument("--list", action="store_true",
                    help="enumerate the artifacts and exit")
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"artifacts to write (default: all of {list(ALL)})")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["sampling"]:
        from repro_torch.bench import sampling
        return sampling.main(argv[1:])
    args = ap.parse_args(argv)
    if args.list:
        for name, mod in ALL.items():
            doc = next(iter((mod.__doc__ or "").strip().splitlines()), "")
            print(f"{name:10s} {doc}")
        return 0
    picks = args.names or list(ALL)
    unknown = [n for n in picks if n not in ALL]
    if unknown:
        print(f"unknown benchmark {unknown[0]!r}; known: {sorted(ALL)}")
        return 1
    common.configure(device=args.device, out=args.out)
    t0 = time.time()
    for name in picks:
        ALL[name].main()
    print(f"\n[repro_torch.bench] done in {time.time() - t0:.1f}s "
          f"({len(picks)} artifacts under {args.out}/, device "
          f"{common.device()})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
