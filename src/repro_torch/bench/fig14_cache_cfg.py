"""Fig. 14: energy improvement under three cache configurations
(32K/256K, 64K/256K, 64K/2M) — exercises the DESTINY-surrogate scaling and
the paper's finding that bigger arrays raise per-op CiM energy.

Runs as one :class:`repro_torch.dse.SweepSpace` over (benchmark x cache
config): each benchmark is traced once per cache geometry and priced from
the shared analysis cache."""
from __future__ import annotations

from repro_torch.dse import SweepSpace
from repro_torch.bench.common import SWEEP_BENCHES, banner, emit, engine

CFG_NAMES = ("32K+256K", "64K+256K", "64K+2M")


def space() -> SweepSpace:
    return SweepSpace(workloads=SWEEP_BENCHES, caches=CFG_NAMES)


def run():
    results = engine().run(space())
    by_bench = results.group_by("workload")
    rows = []
    for name in SWEEP_BENCHES:
        row = {"benchmark": name}
        for rec in by_bench[name]:
            row[rec.cache] = round(rec.energy_improvement, 3)
        rows.append(row)
    return rows


def main():
    banner("Fig. 14: energy improvement vs cache configuration")
    rows = run()
    for r in rows:
        print(f"  {r['benchmark']:8s} " +
              " ".join(f"{n}={r[n]:5.2f}" for n in CFG_NAMES))
    emit("fig14_cache_cfg", rows)
    return rows


if __name__ == "__main__":
    main()
