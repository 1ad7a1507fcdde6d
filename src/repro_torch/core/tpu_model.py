"""The accelerator-mode hardware model (twin of ``repro/core/tpu_model.py``).

The paper prices an ARM host with SRAM/FeFET CiM caches; its accelerator
mode prices a model's train step on a chip with a matrix unit, an HBM and
an on-chip vector memory (VMEM), joined by links.  The three questions of
the paper (how much does the workload benefit, at which memory level, with
which technology) become the three roofline terms below.

:class:`TpuChip`, :data:`V5E` and :data:`TPU_PRESETS` are the reference's
design points, carried over as data so that the port prices the same
design space; their values are the reference's (see
``src/repro/core/tpu_model.py`` for where each comes from).  They describe
the design points of the sweep, not the device the port runs on.  Every
function here is the reference's, and gives equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class TpuChip:
    """One chip design point: peak matrix rate (FLOP/s), HBM and link
    bandwidths (B/s), HBM and VMEM capacities (bytes), and the energy of a
    FLOP and of a byte moved through each level (pJ)."""
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12
    hbm_bw: float = 819e9
    ici_bw: float = 50e9
    hbm_bytes: float = 16e9
    vmem_bytes: float = 128e6
    pj_per_flop: float = 0.25
    pj_per_hbm_byte: float = 8.0
    pj_per_ici_byte: float = 3.0
    pj_per_vmem_byte: float = 0.25


V5E = TpuChip()

# Named chip design points of the accelerator-mode DSE axis
# (SweepSpace(tpus=...)), frozen and hashable like
# core.host_model.HOST_PRESETS.  Declared in capability order (by peak
# matrix rate), so "adjacent chip" is a meaningful adaptive-refinement move.
TPU_PRESETS: Dict[str, TpuChip] = {
    "v5e": V5E,
    "v4": TpuChip(name="tpu-v4", peak_flops_bf16=275e12, hbm_bw=1228e9,
                  ici_bw=50e9, hbm_bytes=32e9, vmem_bytes=128e6,
                  pj_per_flop=0.35, pj_per_hbm_byte=10.0, pj_per_ici_byte=4.0,
                  pj_per_vmem_byte=0.3),
    "v5p": TpuChip(name="tpu-v5p", peak_flops_bf16=459e12, hbm_bw=2765e9,
                   ici_bw=100e9, hbm_bytes=95e9, vmem_bytes=128e6,
                   pj_per_flop=0.2, pj_per_hbm_byte=6.0, pj_per_ici_byte=2.5,
                   pj_per_vmem_byte=0.2),
}


@dataclasses.dataclass
class RooflineTerms:
    """The three roofline terms, in seconds, for one step."""
    compute_s: float
    memory_s: float
    collective_s: float
    n_devices: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time: the dominant term (the others are
        assumed to hide behind it)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """dominant / sum: 1.0 means limited by one resource alone."""
        s = self.compute_s + self.memory_s + self.collective_s
        return self.bound_s / s if s > 0 else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s,
            "roofline_fraction": round(self.roofline_fraction, 4),
        }


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, n_devices: int,
                   chip: TpuChip = V5E) -> RooflineTerms:
    """The three-term model, per device:

        compute    = FLOPs / peak FLOP/s
        memory     = bytes / HBM bandwidth
        collective = collective bytes / link bandwidth
    """
    return RooflineTerms(
        compute_s=max(flops_per_device, 0.0) / chip.peak_flops_bf16,
        memory_s=max(bytes_per_device, 0.0) / chip.hbm_bw,
        collective_s=max(collective_bytes_per_device, 0.0) / chip.ici_bw,
        n_devices=n_devices,
    )


def step_energy_pj(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, n_devices: int,
                   chip: TpuChip = V5E) -> Dict[str, float]:
    """Eva-CiM-style whole-system energy of one step (all chips), in pJ."""
    compute = flops_per_device * chip.pj_per_flop * n_devices
    hbm = bytes_per_device * chip.pj_per_hbm_byte * n_devices
    ici = collective_bytes_per_device * chip.pj_per_ici_byte * n_devices
    return {"compute_pj": compute, "hbm_pj": hbm, "ici_pj": ici,
            "total_pj": compute + hbm + ici}


def model_flops(param_count: int, tokens: int, kind: str = "train") -> float:
    """6*N*D for training (forward 2ND + backward 4ND), 2*N*D for
    inference: the 'useful compute' yardstick."""
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * float(param_count) * float(tokens)
