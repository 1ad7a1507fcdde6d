"""Quickstart on the port: evaluate one program on a CiM system.

Twin of ``examples/quickstart.py``::

    PYTHONPATH=src python examples/torch_quickstart.py                # cuda
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Traces the paper's LCS validation workload through the port's Eva-CiM
pipeline (the trace VM -> the cache replay kernel -> IDG offload analysis
with the placement kernel -> reshaping -> the McPAT-analogue profiler) and
prints the system-level verdict for SRAM and FeFET CiM: the reference's
lines, with the same numbers, and a last line naming the device and the
kernels' launches.
"""
import argparse
import sys

from repro_torch.core import (CIM_SET_STT, OffloadConfig, accel,
                              profile_system, trace_program)
from repro_torch.core.columnar import resolve_device
from repro_torch.workloads import build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    before = accel.launch_counts()

    fn, fargs = build("LCS")
    print("tracing LCS through the Eva-CiM VM ...")
    tr = trace_program(fn, *fargs, device=device)
    print(f"  committed instructions : {tr.n_instructions}")
    print(f"  memory accesses        : {tr.mem_accesses()}")
    print(f"  cache stats            : {tr.cache.stats()}")

    for tech in ("sram", "fefet"):
        rep = profile_system(tr, OffloadConfig(cim_set=CIM_SET_STT), tech=tech,
                             device=device)
        s = rep.summary()
        print(f"\n[{tech.upper()}] CiM in L1+L2:")
        print(f"  MACR                : {s['macr']:.3f} "
              f"({'CiM-favorable' if rep.cim_favorable else 'CiM-unfavorable'})")
        print(f"  energy improvement  : {s['energy_improvement']:.2f}x "
              f"({s['base_energy_nj']:.0f} nJ -> {s['cim_energy_nj']:.0f} nJ)")
        print(f"  speedup             : {s['speedup']:.2f}x")
        print(f"  delta from processor: {s['processor_ratio']:+.2f}, "
              f"caches: {s['cache_ratio']:+.2f}")
    after = accel.launch_counts()
    print(f"device: {device} (replay kernel launches "
          f"{after['replay'] - before['replay']}, placement kernel launches "
          f"{after['place'] - before['place']}; 0 on the CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
