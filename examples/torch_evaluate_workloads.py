"""Table VI end-to-end on the port: trace + analyze all 17 benchmark
applications and print speedup / energy improvement / MACR / breakdown per
program.

Twin of ``examples/evaluate_workloads.py``::

    PYTHONPATH=src python examples/torch_evaluate_workloads.py [--tech fefet]
    PYTHONPATH=src python examples/torch_evaluate_workloads.py --device cpu

The reference's columns, with the same numbers; only the timing in
brackets differs, and a last line names the device and the kernels'
launches.
"""
import argparse
import sys
import time

from repro_torch.core import (CIM_SET_FULL, CIM_SET_STT, OffloadConfig,
                              accel, profile_system, trace_program)
from repro_torch.core.columnar import resolve_device
from repro_torch.workloads import CATEGORY, WORKLOADS, build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tech", default="sram", choices=["sram", "fefet"])
    ap.add_argument("--cim-set", default="stt", choices=["stt", "full"])
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    cim_set = CIM_SET_STT if args.cim_set == "stt" else CIM_SET_FULL
    device = resolve_device(args.device)
    before = accel.launch_counts()

    print(f"{'bench':9s} {'cat':7s} {'instrs':>8s} {'MACR':>6s} {'E-impr':>7s} "
          f"{'speedup':>8s} {'proc':>6s} {'cache':>6s} {'verdict'}")
    for name in WORKLOADS:
        t0 = time.time()
        fn, wargs = build(name)
        tr = trace_program(fn, *wargs, device=device)
        rep = profile_system(tr, OffloadConfig(cim_set=cim_set),
                             tech=args.tech, device=device)
        verdict = "favorable" if rep.cim_favorable else "unfavorable"
        print(f"{name:9s} {CATEGORY[name]:7s} {tr.n_instructions:8d} "
              f"{rep.macr:6.3f} {rep.energy_improvement:7.2f} "
              f"{rep.speedup:8.2f} {rep.processor_ratio:6.2f} "
              f"{rep.cache_ratio:6.2f} {verdict}  ({time.time()-t0:.1f}s)")
    after = accel.launch_counts()
    print(f"device: {device} (replay kernel launches "
          f"{after['replay'] - before['replay']}, placement kernel launches "
          f"{after['place'] - before['place']}; 0 on the CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
