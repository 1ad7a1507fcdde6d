"""§Roofline report builder: reads the dry-run JSON artifacts and derives
the per-(arch x shape x mesh) three-term roofline table (port of
``repro.core.roofline``).

It reads the port's dry-run artifacts (``repro_torch.launch.dryrun``,
``build/dryrun_torch/`` or ``DRYRUN_DIR``), not the reference's.  Every
function is the reference's and a pure function of a record: equal
records give equal rows.  The chip is the reference's design point
(:data:`~repro_torch.core.tpu_model.V5E`), data of the model, not a rate
of the device the port runs on.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.tpu_model import (TpuChip, V5E, model_flops,
                                        roofline_terms, step_energy_pj)


def _art() -> pathlib.Path:
    from repro_torch.launch.dryrun import ART
    return ART


def analytic_bytes_per_device(cfg, shape, n_dev: int, mp: int = 16) -> float:
    """Fusion-ideal HBM traffic per device per step (lower bound).

    The HLO-derived ``bytes_scaled`` is a NO-fusion upper bound (CPU-backend
    HLO keeps every intermediate); real TPU executables fuse elementwise
    chains, so the §Roofline memory term uses this analytic minimum:
    parameter/optimizer traffic (sharded: params over the model axis,
    ZeRO-1 optimizer over all devices) + activation residuals + logits +
    KV/state traffic.  Both bounds are reported.
    """
    dp = max(n_dev // mp, 1)
    P = cfg.param_count()
    Pa = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    kv_dim = cfg.kv_dim

    if shape.kind == "train":
        # fwd read + bwd read + remat re-read (bf16) + grad write/read (f32)
        param_traffic = (2 + 2 + 2) * Pa + 8 * Pa
        param_traffic /= mp                        # params sharded over model
        opt_traffic = (16 + 2) * P / n_dev          # ZeRO-1: m,v rw + update
        acts = 12.0 * L * B * S * d / n_dev         # block-remat residuals
        logits = 2 * 2.0 * B * S * V / n_dev        # fwd + bwd
        return param_traffic + opt_traffic + acts + logits
    if shape.kind == "prefill":
        param_traffic = 2 * Pa / mp
        acts = 4.0 * L * B * S * d / n_dev
        kv = 2 * 2.0 * L * B * S * kv_dim / n_dev   # cache write
        logits = 2.0 * B * S * V / n_dev
        return param_traffic + acts + kv + logits
    # decode: every token reads all (active) params + the live context
    param_traffic = 2 * Pa / mp
    if shape.name == "long_500k" and cfg.supports_long_decode:
        window = cfg.sliding_window or 2048
        ctx = min(S, window)
        state = 0.0
        if cfg.has_ssm_state:
            ssm = cfg.ssm
            state = 4.0 * L * B * ssm.n_heads * ssm.head_dim * max(ssm.d_state, ssm.head_dim)
        kv = 2 * 2.0 * L * B * ctx * kv_dim + state
    else:
        kv = 2 * 2.0 * L * B * S * kv_dim
    logits = 2.0 * B * V
    return param_traffic + (kv + logits) / n_dev


def load_cell(arch: str, shape: str, mesh: str = "single") -> Optional[dict]:
    p = _art() / mesh / f"{arch}__{shape}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def cell_roofline(rec: dict, chip: TpuChip = V5E) -> Optional[Dict]:
    """One roofline row from one dry-run artifact."""
    if not rec.get("ok"):
        return None
    n_dev = rec["n_devices"]
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    # prefer the trip-count-aware static analysis (cost_analysis counts
    # scan bodies once — see core/hlo_cost.py)
    flops = rec.get("flops_scaled_per_device") or rec["flops_per_device"]
    nofusion_bytes = (rec.get("bytes_scaled_per_device")
                      or rec["bytes_accessed_per_device"])
    mp = 16 if n_dev % 16 == 0 else 1
    fused_bytes = analytic_bytes_per_device(cfg, shape, n_dev, mp=mp)
    coll = rec.get("collective_scaled_total") or \
        rec.get("collectives", {}).get("total", 0)
    terms = roofline_terms(flops, fused_bytes, coll, n_dev, chip)
    kind = "train" if shape.kind == "train" else "serve"
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
    else:                                   # decode: one new token per seq
        tokens = shape.global_batch
    n_params = rec.get("active_params") or cfg.active_param_count()
    mf = model_flops(n_params, tokens, "train" if kind == "train" else "serve")
    mf_per_dev = mf / n_dev
    useful = mf_per_dev / flops if flops and flops > 0 else 0.0
    energy = step_energy_pj(flops, fused_bytes, coll, n_dev, chip)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        **terms.as_dict(),
        "memory_s_nofusion": nofusion_bytes / chip.hbm_bw,
        "model_flops_per_dev": mf_per_dev,
        "hlo_flops_per_dev": flops,
        "useful_compute_ratio": round(useful, 4),
        "hbm_bytes_per_dev": fused_bytes,
        "hbm_bytes_nofusion_per_dev": nofusion_bytes,
        "collective_bytes_per_dev": coll,
        "energy_j": round(energy["total_pj"] * 1e-12, 4),
        "n_devices": n_dev,
    }


def full_table(mesh: str = "single") -> List[Dict]:
    rows: List[Dict] = []
    d = _art() / mesh
    if not d.exists():
        return rows
    for p in sorted(d.glob("*.json")):
        rec = json.loads(p.read_text())
        row = cell_roofline(rec)
        if row is not None:
            rows.append(row)
    return rows


def markdown_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
           "dominant | useful/HLO | roofline frac |")
    sep = "|" + "---|" * 8
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['useful_compute_ratio']:.3f} | "
            f"{r['roofline_fraction']:.3f} |")
    return "\n".join(out)
