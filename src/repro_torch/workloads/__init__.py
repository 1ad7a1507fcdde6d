"""The paper's 17 benchmark applications (Table IV).

Twin of ``repro.workloads``.  Until the port's trace frontend lands, the
workloads are their committed structural traces
(:mod:`repro_torch.workloads.fixtures`).
"""
from repro_torch.workloads.fixtures import (CATEGORY, WORKLOADS,
                                            load_structural)

__all__ = ["CATEGORY", "WORKLOADS", "load_structural"]
