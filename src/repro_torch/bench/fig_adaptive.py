"""Adaptive vs exhaustive DSE: identical Pareto frontier, ≥3x fewer points.

The paper's §VI-D/E sweeps price full cross-products; this benchmark runs
the same 5-axis design space twice — once exhaustively, once with
:class:`repro_torch.dse.AdaptiveDSE` (coarse seed → frontier →
axis-neighborhood refinement) — and checks two things per workload: the adaptive run's final
per-workload Pareto frontier is *identical* to the exhaustive one, and it
priced at least 3x fewer design points to get there.  The host axis is
declared in its physical order (increasing micro-architectural
aggressiveness), so "neighboring host" is a meaningful refinement move.
"""
from __future__ import annotations

from repro_torch.core.cache import CacheConfig, L2_2M
from repro_torch.dse import AdaptiveDSE, SweepSpace
from repro_torch.bench.common import banner, emit, engine

WORKLOADS = ("KM", "BFS", "NB")
CACHES = ("32K+256K", "64K+256K", "64K+2M",
          (CacheConfig("L1", 128 * 1024, 4), L2_2M))   # small -> large
LEVELS = ("L1_only", "L2_only", "both")
TECHS = ("sram", "fefet")
HOSTS = ("inorder-1GHz", "A9-1GHz", "A9-2GHz", "big-OoO-2GHz")
OBJECTIVES = ("energy_improvement", "speedup")
MIN_SAVINGS = 3.0


def _ident(rec):
    return (rec.workload, rec.cache, rec.cim_levels, rec.tech, rec.cim_set,
            rec.host)


def space() -> SweepSpace:
    return SweepSpace(workloads=WORKLOADS, caches=CACHES, cim_levels=LEVELS,
                      techs=TECHS, hosts=HOSTS)


def run():
    full = space()
    eng = engine()
    exhaustive = eng.run(full)
    adaptive = AdaptiveDSE(full, engine=eng, objectives=OBJECTIVES).run()

    ex_front = {_ident(r) for r in exhaustive.pareto(OBJECTIVES)}
    ad_front = {_ident(r) for r in adaptive.frontier}
    per_workload = len(full) // len(WORKLOADS)

    rows = []
    for name in WORKLOADS:
        priced = sum(1 for r in adaptive.results if r.workload == name)
        exf = {i for i in ex_front if i[0] == name}
        adf = {i for i in ad_front if i[0] == name}
        rows.append({
            "benchmark": name,
            "full_points": per_workload,
            "adaptive_points": priced,
            "savings": round(per_workload / priced, 2),
            "frontier_size": len(exf),
            "frontier_identical": exf == adf,
        })
    rows.append({
        "benchmark": "ALL",
        "full_points": len(full),
        "adaptive_points": adaptive.n_priced,
        "savings": round(adaptive.savings, 2),
        "frontier_size": len(ex_front),
        "frontier_identical": ex_front == ad_front,
        "rounds": len(adaptive.rounds),
    })

    # the headline claims are assertions, not prose: CI catches regressions
    assert ex_front == ad_front, "adaptive frontier diverged from exhaustive"
    assert adaptive.savings >= MIN_SAVINGS, (
        f"adaptive priced {adaptive.n_priced}/{len(full)} points "
        f"({adaptive.savings:.2f}x), below the {MIN_SAVINGS}x target")
    return rows, adaptive


def main():
    banner("Adaptive DSE: frontier-driven refinement vs full cross-product")
    rows, adaptive = run()
    for r in rows:
        print(f"  {r['benchmark']:8s} {r['adaptive_points']:3d}/"
              f"{r['full_points']:3d} points ({r['savings']:5.2f}x fewer), "
              f"frontier {r['frontier_size']:2d} "
              f"{'identical' if r['frontier_identical'] else 'DIVERGED'}")
    print()
    for line in adaptive.summary().splitlines():
        print(f"  {line}")
    emit("fig_adaptive", rows)
    return rows


if __name__ == "__main__":
    main()
