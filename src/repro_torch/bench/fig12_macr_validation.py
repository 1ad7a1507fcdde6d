"""Fig. 12: offloaded-memory-access share on LCS vs [23].

The paper compares against STT-CiM's emulation platform (in-order core,
1 MB single-level SPM): Eva-CiM selects ~65% of memory accesses for
offloading, [23] reports ~58%.  We rebuild the [23]-like configuration
(single-level 1 MB cache, STT op set) and report our share alongside the
default two-level hierarchy."""
from __future__ import annotations

from repro_torch.core import (CIM_SET_STT, OffloadConfig, SPM_1M,
                        select_candidates)
from repro_torch.bench.common import banner, cached_trace, device, emit

PAPER_EVA = 0.65
PAPER_23 = 0.58

# placements this driver makes outside the engine's offload layer (one
# placement-kernel launch each on the card)
DIRECT_SELECTIONS = 2


def run():
    rows = []
    # [23]-like: single-level 1 MB SPM/cache
    tr = cached_trace("LCS", (SPM_1M,))
    res = select_candidates(tr.trace, cfg=OffloadConfig(cim_set=CIM_SET_STT,
                                                        cim_levels=("L1",)),
                            device=device())
    mb = res.macr_breakdown(tr.trace)
    rows.append({"config": "1MB SPM (as [23])", "offload_share": round(mb["macr"], 3),
                 "paper_eva_cim": PAPER_EVA, "paper_[23]": PAPER_23})
    # default hierarchy
    tr2 = cached_trace("LCS")
    res2 = select_candidates(tr2.trace, cfg=OffloadConfig(cim_set=CIM_SET_STT),
                             device=device())
    mb2 = res2.macr_breakdown(tr2.trace)
    rows.append({"config": "32K L1 + 256K L2", "offload_share": round(mb2["macr"], 3),
                 "paper_eva_cim": PAPER_EVA, "paper_[23]": PAPER_23})
    return rows


def main():
    banner("Fig. 12: CiM-supported access share on LCS (vs [23])")
    rows = run()
    for r in rows:
        print(f"  {r['config']:22s} offloaded {r['offload_share']*100:5.1f}%  "
              f"(paper: Eva-CiM {r['paper_eva_cim']*100:.0f}%, "
              f"[23] {r['paper_[23]']*100:.0f}%)")
    emit("fig12_macr_validation", rows)
    return rows


if __name__ == "__main__":
    main()
