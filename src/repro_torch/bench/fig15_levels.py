"""Fig. 15: energy improvement with CiM in L1 only, L2 only, or both —
the paper's 'which level should host the CiM?' question.

One sweep over (benchmark x CiM level set); the trace/IDG analysis is
shared across all three level choices per benchmark (only candidate
selection re-runs), which is exactly the reuse the DSE engine memoizes."""
from __future__ import annotations

from repro_torch.dse import SweepSpace
from repro_torch.bench.common import SWEEP_BENCHES, banner, emit, engine

LEVEL_NAMES = ("L1_only", "L2_only", "both")
_COLUMN_OF = {"L1": "L1_only", "L2": "L2_only", "L1+L2": "both"}


def space() -> SweepSpace:
    return SweepSpace(workloads=SWEEP_BENCHES, cim_levels=LEVEL_NAMES)


def run():
    results = engine().run(space())
    by_bench = results.group_by("workload")
    rows = []
    for name in SWEEP_BENCHES:
        row = {"benchmark": name}
        for rec in by_bench[name]:
            row[_COLUMN_OF[rec.cim_levels]] = round(rec.energy_improvement, 3)
        row["l2_worst"] = row["L2_only"] <= min(row["L1_only"],
                                                row["both"]) + 1e-9
        rows.append(row)
    return rows


def main():
    banner("Fig. 15: energy improvement vs CiM level")
    rows = run()
    for r in rows:
        print(f"  {r['benchmark']:8s} L1 {r['L1_only']:5.2f}  "
              f"L2 {r['L2_only']:5.2f}  both {r['both']:5.2f}"
              f"{'   (L2-only lowest ok)' if r['l2_worst'] else ''}")
    emit("fig15_levels", rows)
    return rows


if __name__ == "__main__":
    main()
