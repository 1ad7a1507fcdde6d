"""Accelerator-mode MACR: fusion candidates over every arch's reduced train step.

Twin of ``benchmarks/tpu_macr.py``: "is this model step fusion-favorable
on the accelerator's memory hierarchy?"  Each arch's reduced train step
(B=2, S=32) is recorded as an ATen graph on the configured device and
walked by :func:`repro_torch.core.hlo.fusion_candidates`.  The rows have
the reference's columns; their values are the port's graph's, which sees
every layer where the reference's top-level jaxpr walk does not (ROADMAP
Queue 3).
"""
from __future__ import annotations

from repro_torch.configs.registry import ARCHS, reduced_config
from repro_torch.core.hlo import fusion_candidates
from repro_torch.dse.backends import record_train_step
from repro_torch.bench.common import banner, device, emit


def run():
    rows = []
    dev = device()
    for arch in sorted(ARCHS):
        graph = record_train_step(reduced_config(arch), 2, 32, dev)
        rep = fusion_candidates(graph)
        big = max(rep.candidates, key=lambda c: c.saved_bytes, default=None)
        rows.append({
            "arch": arch,
            "n_candidates": len(rep.candidates),
            "total_mb": round(rep.total_bytes / 1e6, 2),
            "saved_mb": round(rep.saved_bytes / 1e6, 2),
            "tpu_macr": round(rep.tpu_macr, 4),
            "biggest_chain_ops": big.n_ops if big else 0,
        })
    return rows


def main():
    banner("TPU-mode MACR: VMEM-fusion candidates per arch (reduced step)")
    rows = run()
    for r in rows:
        print(f"  {r['arch']:24s} cands {r['n_candidates']:4d} "
              f"traffic {r['total_mb']:8.2f}MB eliminable {r['saved_mb']:8.2f}MB "
              f"tpu_macr {r['tpu_macr']:.3f} (max chain {r['biggest_chain_ops']})")
    emit("tpu_macr", rows)
    return rows


if __name__ == "__main__":
    main()
