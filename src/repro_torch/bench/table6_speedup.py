"""Table VI: speedup, energy improvement, and the processor/cache
contribution breakdown for all 17 benchmarks (CiM vs non-CiM system)."""
from __future__ import annotations

from repro_torch.core import OffloadConfig, profile_system
from repro_torch.workloads import WORKLOADS
from repro_torch.bench.common import banner, cached_trace, device, emit

# placements this driver makes outside the engine's offload layer (one
# placement-kernel launch each on the card)
DIRECT_SELECTIONS = len(WORKLOADS)

PAPER = {  # benchmark: (speedup, energy improvement) from Table VI
    "NB": (1.51, 3.28), "DT": (1.52, 5.12), "SVM": (1.42, 2.83),
    "LiR": (1.24, 2.68), "KM": (1.30, 3.21), "LCS": (1.31, 4.31),
    "M2D": (1.34, 4.85), "BFS": (1.40, 2.33), "DFS": (1.55, 1.98),
    "BC": (0.99, 1.30), "SSSP": (1.34, 2.33), "CCOMP": (1.52, 3.46),
    "PRANK": (1.42, 4.54), "astar": (1.28, 5.26), "h264ref": (1.17, 2.05),
    "hmmer": (1.36, 2.87), "mcf": (1.27, 3.58),
}


def run():
    rows = []
    for name in WORKLOADS:
        tr = cached_trace(name)
        rep = profile_system(tr, OffloadConfig(), device=device())
        p_spd, p_ei = PAPER[name]
        rows.append({
            "benchmark": name,
            "speedup": round(rep.speedup, 3),
            "energy_improvement": round(rep.energy_improvement, 3),
            "processor_ratio": round(rep.processor_ratio, 3),
            "cache_ratio": round(rep.cache_ratio, 3),
            "macr": round(rep.macr, 4),
            "paper_speedup": p_spd, "paper_energy_improvement": p_ei,
            "in_speedup_band": 0.95 <= rep.speedup <= 1.6,
        })
    return rows


def main():
    banner("Table VI: speedup + energy improvement (SRAM CiM)")
    rows = run()
    print(f"  {'bench':8s} {'spd':>6s} {'(paper)':>8s} {'E-imp':>7s} "
          f"{'(paper)':>8s} {'proc':>6s} {'cache':>6s}")
    for r in rows:
        print(f"  {r['benchmark']:8s} {r['speedup']:6.2f} "
              f"({r['paper_speedup']:5.2f}) {r['energy_improvement']:7.2f} "
              f"({r['paper_energy_improvement']:5.2f}) "
              f"{r['processor_ratio']:6.2f} {r['cache_ratio']:6.2f}")
    spd = [r["speedup"] for r in rows]
    ei = [r["energy_improvement"] for r in rows]
    print(f"  ranges: speedup {min(spd):.2f}-{max(spd):.2f} "
          f"(paper 0.99-1.55), E-imp {min(ei):.2f}-{max(ei):.2f} "
          f"(paper 1.30-5.26)")
    emit("table6_speedup", rows)
    return rows


if __name__ == "__main__":
    main()
