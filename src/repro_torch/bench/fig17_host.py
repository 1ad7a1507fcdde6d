"""Fig. 17 (repo extension): energy improvement and speedup vs host CPU —
the paper's §VI-D host/CiM-interaction question swept as a first-class axis.

One sweep over (benchmark x host preset).  The host model is pure
pricing-phase input, so the whole figure re-uses the trace/IDG analysis
*and* the candidate selection of every benchmark — the engine reports zero
additional analysis builds beyond the per-workload trace.  The expected
shape: a small in-order host leaves the most memory wall for CiM to remove
(largest energy win, but unhidden CiM op latency can cost speedup), while a
wide/fast OoO host hides miss latency itself and shrinks CiM's headroom.
"""
from __future__ import annotations

from repro_torch.core.host_model import HOST_PRESETS
from repro_torch.dse import SweepSpace
from repro_torch.bench.common import SWEEP_BENCHES, banner, emit, engine

HOSTS = tuple(HOST_PRESETS)


def space() -> SweepSpace:
    return SweepSpace(workloads=SWEEP_BENCHES, hosts=HOSTS)


def run():
    results = engine().run(space())
    by_bench = results.group_by("workload")
    rows = []
    for name in SWEEP_BENCHES:
        row = {"benchmark": name}
        for rec in by_bench[name]:
            row[f"{rec.host}_improvement"] = round(rec.energy_improvement, 3)
            row[f"{rec.host}_speedup"] = round(rec.speedup, 3)
            # wall-clock, not cycles: the 2 GHz presets halve this even
            # where the cycle-count speedup barely moves
            row[f"{rec.host}_cim_ms"] = round(rec.cim_runtime_ms, 4)
        rows.append(row)
    return rows


def main():
    banner("Fig. 17: energy improvement / speedup vs host CPU model")
    rows = run()
    for r in rows:
        cells = "  ".join(f"{h} {r[f'{h}_improvement']:5.2f}x"
                          f"/{r[f'{h}_speedup']:4.2f}x" for h in HOSTS)
        print(f"  {r['benchmark']:8s} {cells}")
    emit("fig17_host", rows)
    return rows


if __name__ == "__main__":
    main()
