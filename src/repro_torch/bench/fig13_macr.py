"""Fig. 13: MACR per benchmark (top) + breakdown into L1 / other-level
converted accesses (bottom), for all 17 applications."""
from __future__ import annotations

from repro_torch.core import OffloadConfig, select_candidates
from repro_torch.workloads import WORKLOADS
from repro_torch.bench.common import banner, cached_trace, device, emit

# placements this driver makes outside the engine's offload layer (one
# placement-kernel launch each on the card)
DIRECT_SELECTIONS = len(WORKLOADS)


def run():
    rows = []
    for name in WORKLOADS:
        tr = cached_trace(name)
        res = select_candidates(tr.trace, cfg=OffloadConfig(),
                                device=device())
        mb = res.macr_breakdown(tr.trace)
        rows.append({"benchmark": name, "macr": round(mb["macr"], 4),
                     "l1_share": round(mb["l1"], 4),
                     "other_share": round(mb["other"], 4),
                     "total_accesses": mb["total_accesses"],
                     "cim_favorable": mb["macr"] >= 0.5})
    return rows


def main():
    banner("Fig. 13: MACR breakdown per benchmark")
    rows = run()
    for r in rows:
        bar = "#" * int(r["macr"] * 40)
        print(f"  {r['benchmark']:8s} {r['macr']:6.3f} "
              f"(L1 {r['l1_share']:5.3f} / other {r['other_share']:5.3f}) {bar}")
    emit("fig13_macr", rows)
    return rows


if __name__ == "__main__":
    main()
