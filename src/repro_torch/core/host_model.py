"""Host-CPU energy/latency model — the McPAT analogue (paper §V-C).

Twin of ``repro/core/host_model.py``: a copy, not an import, so the
port never loads the JAX package.  The constants are kept letter for letter.

McPAT prices each committed instruction from per-component performance
counters; our trace VM produces exactly those counters (instruction class,
triggered functional unit, cache level per access).  The default constants
model an ARM Cortex-A9-class out-of-order core at 45 nm / 1 GHz — the
paper's experimental platform (§VI).  They are calibration surrogates for
McPAT output, sized so that core power at IPC ~1 lands in the A9's
published 0.5–1 W envelope; the validation benchmark (Table V) checks the
resulting CiM/non-CiM energy *ratios* against the paper.

:data:`HOST_PRESETS` names the host-CPU design points the DSE sweeps
(``SweepSpace(hosts=...)``): the paper varies the host to quantify how much
of CiM's benefit depends on what it is attached to — a small in-order core
leaves more of the memory wall for CiM to remove, while a wide/fast OoO
core hides miss latency itself (and pays for it in pipeline energy).
Frequency variants keep the micro-architecture but re-express the fixed
DRAM/L2 nanosecond latencies in (more) core cycles and dilute per-cycle
static energy, which shifts both the speedup and the static-energy term.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

from repro_torch.core.isa import (U_BRANCH, U_FP_ALU, U_FP_DIV, U_FP_MUL,
                            U_FP_SPECIAL, U_INT_ALU, U_INT_DIV, U_INT_MUL,
                            U_MEM_RD, U_MEM_WR, U_SIMD, Inst)


class FrozenUnitMap(dict):
    """Immutable, hashable unit->pJ mapping.

    :class:`HostModel` is a frozen dataclass, but a plain ``dict`` field
    defeats its generated ``__hash__`` — and sweep-point dedup (adaptive
    refinement, set membership of :class:`~repro.dse.space.SweepPoint`)
    needs host-carrying points to hash.  This keeps the full read-side dict
    API (``.get``, iteration, ``==`` against plain dicts, and therefore the
    ``HOST_PRESETS`` equality lookup in ``HostOption.of``) while rejecting
    mutation and hashing by value.
    """

    def _frozen(self, *args, **kwargs):
        raise TypeError("HostModel.unit_pj is immutable; build a new "
                        "HostModel to change unit energies")

    __setitem__ = __delitem__ = __ior__ = _frozen
    clear = pop = popitem = setdefault = update = _frozen

    def __hash__(self):
        return hash(frozenset(self.items()))

    def __reduce__(self):
        # default dict-subclass pickling repopulates via the (blocked)
        # __setitem__; rebuild through the C-level dict constructor instead
        return (self.__class__, (dict(self),))


@dataclasses.dataclass(frozen=True)
class HostModel:
    # --- energy (pJ) ------------------------------------------------------
    # front-end + rename + IQ/ROB + regfile + bypass + commit, per instruction
    pipeline_pj: float = 180.0
    # static + clock-tree power burned per cycle regardless of activity
    # (~30% of A9 package power at 45 nm) — McPAT's P_static * T term, which
    # couples runtime reduction into the energy improvement
    static_pj_per_cycle: float = 150.0
    unit_pj: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: FrozenUnitMap({
            U_INT_ALU: 15.0, U_INT_MUL: 40.0, U_INT_DIV: 90.0,
            U_FP_ALU: 40.0, U_FP_MUL: 60.0, U_FP_DIV: 140.0,
            U_FP_SPECIAL: 160.0,
            U_MEM_RD: 20.0, U_MEM_WR: 20.0,    # LSQ/AGU (cache array priced
            U_BRANCH: 12.0, U_SIMD: 30.0,      #  separately via Table III)
        }))
    # --- timing (cycles @ 1 GHz) -------------------------------------------
    # A9 is dual-issue OoO: sustained ~1.5 instructions/cycle on these
    # kernels => effective CPI ~0.65 for pipelined instructions.
    base_cpi: float = 0.65
    # additional stall beyond the pipelined L1 path, scaled by an OoO
    # overlap factor (the window hides part of the miss latency)
    l2_stall: float = 8.0
    mem_stall: float = 60.0
    overlap: float = 0.4
    # CiM array-op timing: each array op in a macro-instruction occupies the
    # bank for ~1 pipelined slot; latency beyond an L1 read is partly hidden
    # by the OoO window (§V-C2: CiM ADD's +4 cycles "may result in severe
    # pipeline stall" — cim_overlap is the unhidden fraction)
    cim_occupancy: float = 0.35
    cim_overlap: float = 0.2
    # --- identity -----------------------------------------------------------
    # preset name (sweep axis label) + clock, appended last so positional
    # construction of the pricing constants above stays source-compatible
    name: str = "A9-1GHz"
    freq_ghz: float = 1.0

    def __post_init__(self):
        # accept plain dicts at construction but store the frozen mapping,
        # so every HostModel (and anything carrying one) is hashable
        if not isinstance(self.unit_pj, FrozenUnitMap):
            object.__setattr__(self, "unit_pj", FrozenUnitMap(self.unit_pj))

    def inst_energy_pj(self, inst: Inst) -> float:
        return self.pipeline_pj + self.unit_pj.get(inst.unit, 15.0)

    def inst_cycles(self, inst: Inst) -> float:
        c = self.base_cpi
        if inst.is_mem:
            if inst.level == "L2":
                c += self.l2_stall * self.overlap
            elif inst.level == "MEM":
                c += self.mem_stall * self.overlap
        return c

    def runtime_ms(self, cycles: float) -> float:
        return cycles / (self.freq_ghz * 1e9) * 1e3


DEFAULT_HOST = HostModel()

# ---------------------------------------------------------------------------
# Named host design points for the DSE host axis (SweepSpace(hosts=...)).
# All pricing constants are surrogates in the same calibration family as the
# A9 baseline; what matters for the sweep is the *relative* movement of the
# pipeline-energy / static-energy / stall-hiding trade-off across presets.
# ---------------------------------------------------------------------------
HOST_PRESETS: Dict[str, HostModel] = {
    # the paper's §VI platform: dual-issue OoO A9 @ 1 GHz (== DEFAULT_HOST)
    "A9-1GHz": DEFAULT_HOST,
    # Cortex-A7-class in-order single-issue core: no rename/ROB (cheap
    # pipeline, low leakage) but almost no miss-latency hiding, so stalls —
    # and the CiM op latency beyond an L1 read — land nearly in full
    "inorder-1GHz": HostModel(
        pipeline_pj=80.0, static_pj_per_cycle=60.0,
        base_cpi=1.15, l2_stall=8.0, mem_stall=60.0, overlap=0.9,
        cim_occupancy=0.5, cim_overlap=0.65,
        name="inorder-1GHz", freq_ghz=1.0),
    # the same A9 micro-architecture clocked at 2 GHz: fixed-ns L2/DRAM
    # latencies double in cycles (the memory wall bites harder) while the
    # fixed leakage *power* spreads over twice as many cycles per second
    "A9-2GHz": HostModel(
        static_pj_per_cycle=75.0,
        l2_stall=16.0, mem_stall=120.0,
        name="A9-2GHz", freq_ghz=2.0),
    # A15/"big"-class 3-wide OoO @ 2 GHz: a deep window hides most of the
    # miss (and CiM) latency itself, at a steep pipeline + leakage premium —
    # the host that gives CiM the least performance headroom
    "big-OoO-2GHz": HostModel(
        pipeline_pj=300.0, static_pj_per_cycle=260.0,
        base_cpi=0.4, l2_stall=16.0, mem_stall=120.0, overlap=0.2,
        cim_occupancy=0.3, cim_overlap=0.08,
        name="big-OoO-2GHz", freq_ghz=2.0),
}
