"""§Roofline: per-(arch x shape) three-term roofline table from the dry-run
artifacts (single-pod 16x16 mesh).

Twin of ``benchmarks/roofline.py``: it reads the port's dry-run artifacts
(``python -m repro_torch.launch.dryrun``; ``build/dryrun_torch/`` or
``DRYRUN_DIR``) and prints whatever cells exist.  The terms are the
reference's design point (v5e), as the reference prices them.
"""
from __future__ import annotations

from repro_torch.bench.common import banner, emit
from repro_torch.core.roofline import full_table


def run():
    return full_table("single")


def main():
    banner("Roofline: three terms per (arch x shape), single-pod 16x16")
    rows = run()
    if not rows:
        print("  (no dry-run artifacts yet — run "
              "`PYTHONPATH=src python -m repro_torch.launch.dryrun "
              "--mesh single`)")
        return rows
    for r in rows:
        print(f"  {r['arch']:24s} {r['shape']:12s} "
              f"C {r['compute_s']:9.4f}s M {r['memory_s']:9.4f}s "
              f"X {r['collective_s']:9.4f}s -> {r['dominant']:10s} "
              f"useful {r['useful_compute_ratio']:6.3f} "
              f"frac {r['roofline_fraction']:.3f}")
    emit("roofline", rows)
    return rows


if __name__ == "__main__":
    main()
