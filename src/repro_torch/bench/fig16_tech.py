"""Fig. 16: SRAM vs FeFET CiM — energy improvement normalized to the SRAM
non-CiM baseline (the paper's normalization) + speedup comparison.

A pure technology sweep: per benchmark the engine re-prices the *same*
memoized trace + candidate set under each Table III device model, so the
whole figure costs one analysis pass per workload."""
from __future__ import annotations

from repro_torch.dse import SweepSpace
from repro_torch.workloads import WORKLOADS
from repro_torch.bench.common import banner, emit, engine


def space() -> SweepSpace:
    return SweepSpace(workloads=tuple(WORKLOADS), techs=("sram", "fefet"))


def run():
    results = engine().run(space())
    by_bench = results.group_by("workload")
    rows = []
    for name in WORKLOADS:
        sram, fefet = by_bench[name]
        assert (sram.tech, fefet.tech) == ("sram", "fefet")
        base = sram.base_energy_pj                   # SRAM non-CiM baseline
        rows.append({
            "benchmark": name,
            "sram_improvement": round(base / sram.cim_energy_pj, 3),
            "fefet_improvement": round(base / fefet.cim_energy_pj, 3),
            "sram_speedup": round(sram.speedup, 3),
            "fefet_speedup": round(fefet.speedup, 3),
            "fefet_gain_pct": round(
                (base / fefet.cim_energy_pj)
                / (base / sram.cim_energy_pj) * 100 - 100, 1),
        })
    return rows


def main():
    banner("Fig. 16: SRAM vs FeFET (normalized to SRAM non-CiM baseline)")
    rows = run()
    for r in rows:
        print(f"  {r['benchmark']:8s} E-imp SRAM {r['sram_improvement']:5.2f} "
              f"FeFET {r['fefet_improvement']:5.2f} ({r['fefet_gain_pct']:+5.1f}%)  "
              f"spd {r['sram_speedup']:.2f}/{r['fefet_speedup']:.2f}")
    gains = [r["fefet_gain_pct"] for r in rows]
    print(f"  FeFET gain range: {min(gains):+.1f}% .. {max(gains):+.1f}% "
          f"(paper: +50-70%)")
    emit("fig16_tech", rows)
    return rows


if __name__ == "__main__":
    main()
