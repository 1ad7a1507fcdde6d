"""Accelerator-mode selection and pricing of one design point from its
analysis numbers, copied (not imported) from the program's
``dse/backends.py::TpuBackend`` and ``core/tpu_model.py``, operation for
operation, so that equal inputs give equal floats: the check recomputes
every record's priced columns from the analysis the unit built.  The chip
presets are the program's design points, as data.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

#: name -> (label, peak FLOP/s, HBM B/s, link B/s, VMEM bytes, pJ/FLOP,
#: pJ/HBM byte, pJ/link byte, pJ/VMEM byte)
CHIPS: Dict[str, Tuple] = {
    "v5e": ("v5e", 197e12, 819e9, 50e9, 128e6, 0.25, 8.0, 3.0, 0.25),
    "v4": ("v4", 275e12, 1228e9, 50e9, 128e6, 0.35, 10.0, 4.0, 0.3),
    "v5p": ("v5p", 459e12, 2765e9, 100e9, 128e6, 0.2, 6.0, 2.5, 0.2),
}


def parse_bytes(spec: str) -> int:
    s = spec.strip().upper()
    for suffix, shift in (("M", 20), ("K", 10)):
        if s.endswith(suffix):
            return int(s[:-1]) << shift
    return int(s)


def threshold_label(n: int) -> str:
    if n >= 1 << 20 and n % (1 << 20) == 0:
        return f"thr{n >> 20}M"
    if n >= 1 << 10 and n % (1 << 10) == 0:
        return f"thr{n >> 10}K"
    return f"thr{n}"


def _bound(flops, nbytes, coll, chip) -> float:
    _, peak, hbm, ici = chip[:4]
    return max(max(flops, 0.0) / peak, max(nbytes, 0.0) / hbm,
               max(coll, 0.0) / ici)


def _energy(flops, nbytes, coll, chip) -> Dict[str, float]:
    pj_flop, pj_hbm, pj_ici = chip[5:8]
    compute = flops * pj_flop * 1
    hbm = nbytes * pj_hbm * 1
    ici = coll * pj_ici * 1
    return {"compute_pj": compute, "hbm_pj": hbm, "ici_pj": ici,
            "total_pj": compute + hbm + ici}


def price(analysis: Dict, candidates: Sequence[Sequence[int]], chip_name: str,
          threshold: str) -> Dict:
    """The priced columns of one record: ``analysis`` holds ``flops``,
    ``total_bytes``, ``collective_bytes`` and ``n_eqns``; ``candidates``
    rows of (n_ops, input_bytes, output_bytes, saved_bytes)."""
    chip = CHIPS[chip_name]
    min_saved = parse_bytes(threshold)
    vmem = chip[4]
    accepted = [c for c in candidates
                if c[3] >= min_saved and c[1] + c[2] + c[3] // 2 <= vmem]
    saved = sum(c[3] for c in accepted)
    base_bytes = float(analysis["total_bytes"])
    fused_bytes = base_bytes - saved
    flops, coll = analysis["flops"], analysis["collective_bytes"]
    base_s = _bound(flops, base_bytes, coll, chip)
    fused_s = _bound(flops, fused_bytes, coll, chip)
    base_e = _energy(flops, base_bytes, coll, chip)
    fused_e = _energy(flops, fused_bytes, coll, chip)
    fused_total = fused_e["total_pj"] + saved * chip[8]
    macr = (saved / base_bytes) if base_bytes else 0.0
    return {
        "cache": chip[0], "cim_set": threshold_label(min_saved),
        "energy_improvement": (base_e["total_pj"] / fused_total
                               if fused_total else 1.0),
        "speedup": base_s / fused_s if fused_s else 1.0,
        "macr": macr, "macr_l1": macr,
        "base_energy_pj": base_e["total_pj"], "cim_energy_pj": fused_total,
        "base_cycles": base_s * 1e9, "cim_cycles": fused_s * 1e9,
        "base_runtime_ms": base_s * 1e3, "cim_runtime_ms": fused_s * 1e3,
        "processor_ratio": (base_e["compute_pj"] / base_e["total_pj"]
                            if base_e["total_pj"] else 0.0),
        "cache_ratio": (base_e["hbm_pj"] / base_e["total_pj"]
                        if base_e["total_pj"] else 0.0),
        "n_instructions": analysis["n_eqns"],
        "n_mem_accesses": int(analysis["total_bytes"]),
        "n_candidates": len(candidates), "n_cim_ops": sum(
            c[0] for c in accepted),
    }
