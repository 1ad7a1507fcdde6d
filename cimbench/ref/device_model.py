"""Device/CiM-array model — the paper's Table III + Fig. 11, with a
DESTINY-like analytic scaling surrogate for other cache configurations.

The paper obtains per-operation energies from HSPICE device models fed
into a modified DESTINY.  Neither tool runs here, so we (i) embed the
published Table III numbers verbatim as calibration anchors, and
(ii) derive a two-parameter scaling law per (technology, operation):

    E(size, assoc) = E_L1 * (size / 64 KiB)^alpha * (assoc / 4)^beta

with ``beta`` fixed at 0.20 (associativity widens the way-select/compare
path sub-linearly) and ``alpha`` solved per operation so the law passes
*exactly* through both published points (64 KiB/4-way L1 and 256 KiB/8-way
L2).  This reproduces Table III by construction and extrapolates
monotonically for the Fig. 14 design-space sweep (32 KiB L1 … 2 MiB L2) —
including the paper's finding that larger arrays raise per-op CiM energy.

Latencies follow Fig. 11: SRAM CiM logic ops ≈ non-CiM read latency
(difference "almost negligible"), CiM ADD ≈ read + 4 cycles; FeFET CiM is
faster than SRAM CiM at every operation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from cimbench.ref.cache import CacheConfig

KB = 1024

# ---------------------------------------------------------------- Table III
# energies in pJ per operation; anchors: (64kB, 4-way) and (256kB, 8-way)
_TABLE3: Dict[str, Dict[str, Tuple[float, float]]] = {
    # op             (L1 anchor, L2 anchor)
    "sram": {
        "read":     (61.0, 314.0),
        "CiM-OR":   (71.0, 341.0),
        "CiM-AND":  (72.0, 344.0),
        "CiM-XOR":  (79.0, 365.0),
        "CiM-ADD":  (79.0, 365.0),
    },
    "fefet": {
        "read":     (34.0, 70.0),
        "CiM-OR":   (35.0, 72.0),
        "CiM-AND":  (88.0, 146.0),
        "CiM-XOR":  (105.0, 205.0),
        "CiM-ADD":  (105.0, 205.0),
    },
}
_ANCHOR_L1 = (64 * KB, 4)
_ANCHOR_L2 = (256 * KB, 8)
_BETA = 0.20

# ------------------------------------------------------- Fig. 11 latencies
# access cycles at 1 GHz; {tech: {op: (L1 cycles, L2 cycles)}}
_LATENCY: Dict[str, Dict[str, Tuple[int, int]]] = {
    "sram": {
        "read":    (2, 8),
        "CiM-OR":  (2, 8),       # logic ops ~= read ("almost negligible")
        "CiM-AND": (2, 8),
        "CiM-XOR": (2, 8),
        "CiM-ADD": (6, 12),      # "almost four more cycles than non-CiM read"
    },
    "fefet": {
        "read":    (2, 6),
        "CiM-OR":  (2, 6),
        "CiM-AND": (2, 6),
        "CiM-XOR": (2, 6),
        "CiM-ADD": (4, 9),       # FeFET CiM outperforms SRAM CiM (Fig. 11/16)
    },
}

# write energy relative to read (array write + precharge; both techs'
# cache-level write path is read-comparable at 45 nm — documented surrogate)
WRITE_FACTOR = 1.15
# bit-serial in-memory multiply surrogate (CIM_SET_FULL only): priced as a
# small multiple of ADD — documented in DESIGN.md §Assumption-changes.
MUL_FACTOR = 4.0


@dataclasses.dataclass(frozen=True)
class TechModel:
    """Per-technology CiM array model with DESTINY-like scaling."""
    tech: str                           # "sram" | "fefet"

    def _alpha(self, op: str) -> float:
        e1, e2 = _TABLE3[self.tech][op]
        s1, a1 = _ANCHOR_L1
        s2, a2 = _ANCHOR_L2
        # solve e2 = e1 * (s2/s1)^alpha * (a2/a1)^beta
        return (math.log(e2 / e1) - _BETA * math.log(a2 / a1)) / math.log(s2 / s1)

    def energy(self, op: str, cache: CacheConfig) -> float:
        """pJ per operation for an arbitrary cache configuration."""
        if op == "write":
            return self.energy("read", cache) * WRITE_FACTOR
        if op == "CiM-MUL":
            return self.energy("CiM-ADD", cache) * MUL_FACTOR
        e1 = _TABLE3[self.tech][op][0]
        s1, a1 = _ANCHOR_L1
        return (e1 * (cache.size / s1) ** self._alpha(op)
                * (cache.assoc / a1) ** _BETA)

    def latency(self, op: str, level: str) -> int:
        """access cycles (1 GHz clock) at cache level 'L1'|'L2'."""
        if op == "write":
            op = "read"
        if op == "CiM-MUL":
            # analog-assisted in-array multiply surrogate (PRIME-class MVM
            # arrays do a multiply per access): ADD latency + 2 cycles.
            base = _LATENCY[self.tech]["CiM-ADD"]
            return (base[0] if level == "L1" else base[1]) + 2
        row = _LATENCY[self.tech].get(op, _LATENCY[self.tech]["read"])
        return row[0] if level == "L1" else row[1]

    # convenience: reproduce Table III verbatim (used by the validation bench)
    def table3_row(self, cache: CacheConfig) -> Dict[str, float]:
        return {op: round(self.energy(op, cache), 1)
                for op in ("read", "CiM-OR", "CiM-AND", "CiM-XOR", "CiM-ADD")}


SRAM = TechModel("sram")
FEFET = TechModel("fefet")
TECHS = {"sram": SRAM, "fefet": FEFET}

# ------------------------------------------------------------------ DRAM
DRAM_ACCESS_PJ = 15_000.0      # pJ per 64 B line activation+transfer (LPDDR-class)
DRAM_LATENCY_CYCLES = 60       # @1 GHz host clock
