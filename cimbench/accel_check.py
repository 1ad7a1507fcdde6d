"""What decides ``correct`` for the accel kind (:mod:`cimbench.kinds.accel`):
what the timed analyses produced, held to the plain reference
(:mod:`cimbench.ref_accel`) at the cell's own sizes.

* ``record_gap`` (every unit): each record's priced columns recomputed
  from the unit's analysis numbers (:mod:`cimbench.ref_accel.pricing`),
  the largest relative difference; the arithmetic is the same operation
  for operation, so the limit is 0.  A record missing or its labels wrong
  counts 1.
* ``flops_gap`` (every unit): the recorded graph's matrix-product FLOPs
  over the step's count from the widths and the unit's routing
  (:mod:`cimbench.ref_accel.flops`): 0 while that ratio lies in
  ``[1, FLOPS_RATIO_MAX]``, else its distance from the interval.  Under 1
  the graph lacks work the model has; above the bound it holds work it
  should not (a remat recomputation, attention's masked blocks and the
  SSD's own products are the allowance).
* For each unit the window still holds (the last and one drawn): the
  reference recomputes the unit's step in float32 from the unit's seed,
  under the unit's routing, one layer at a time:

  - ``route_gap``: the largest excess, in units of the logits' RMS, of
    an expert a token left out over one it chose, on the reference's
    float32 logits;
  - ``loss_gap``: relative difference of the step's loss;
  - ``grad_gap``: per parameter, ||m - m_ref|| / ||m_ref|| over the
    sampled entries of AdamW's first moment after the step (the clipped
    gradient times 1 - beta1), the largest over the parameters.

The limits (:data:`LIMITS`) and the readings they rest on are in
``PERF.md`` (section 2).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cimbench.ref_accel import granite, pricing
from cimbench.ref_accel.flops import step_flops

#: a correct graph's FLOPs over the step's count lie in [1, this]
FLOPS_RATIO_MAX = 1.6
LIMITS = {"record_gap": 0.0, "flops_gap": 0.0, "route_gap": 0.4,
          "loss_gap": 1e-5, "grad_gap": 0.25}
#: the priced columns of a record
PRICED = ("energy_improvement", "speedup", "macr", "macr_l1",
          "base_energy_pj", "cim_energy_pj", "base_cycles", "cim_cycles",
          "base_runtime_ms", "cim_runtime_ms", "processor_ratio",
          "cache_ratio", "n_instructions", "n_mem_accesses", "n_candidates",
          "n_cim_ops")


class Reference:
    """The reference of one configuration, on the card where there is
    one."""

    def __init__(self, config: Dict):
        self.spec = granite.Spec.of(config)
        self.device = "cuda" if torch.cuda.is_available() else "cpu"

    def step(self, seed: int, batch: int, seq_len: int,
             idx: Dict[str, np.ndarray], routes, num=None):
        params, tokens, labels = granite.draw(self.spec, seed, batch,
                                              seq_len, self.device)
        sample = {p: torch.as_tensor(i) for p, i in idx.items()}
        if routes is not None:
            routes = {i: torch.as_tensor(r) for i, r in routes.items()}
        return granite.step(params, tokens, labels, self.spec, sample, num,
                            routes)


def _rel(a: float, b: float) -> float:
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(a), abs(b))


def record_gap(out: Dict, points: List[Dict]) -> float:
    recs = out["records"]
    if len(recs) != len(points):
        return 1.0
    gap = 0.0
    for rec, p in zip(recs, points):
        want = pricing.price(out["analysis"], out["analysis"]["candidates"],
                             p["chip"], p["threshold"])
        if (rec["cache"], rec["cim_set"]) != (want["cache"], want["cim_set"]):
            return 1.0
        gap = max([gap] + [_rel(rec[k], want[k]) for k in PRICED])
    return gap


def flops_gap(out: Dict, spec, batch: int, seq_len: int) -> float:
    ratio = out["analysis"]["flops"] / step_flops(spec, batch, seq_len,
                                                  out["held_rows"])
    return max(0.0, 1.0 - ratio, ratio - FLOPS_RATIO_MAX)


def grad_gap(m: Dict[str, np.ndarray], want: Dict[str, torch.Tensor]
             ) -> float:
    gap = 0.0
    for path, ref in want.items():
        ref = ref.double().cpu().numpy()
        diff = np.linalg.norm(np.asarray(m[path], np.float64) - ref)
        norm = np.linalg.norm(ref)
        gap = max(gap, diff / norm if norm else (0.0 if diff == 0 else 1.0))
    return gap


def compare(sample: Dict, ref: Reference) -> Dict[str, float]:
    """The numbers compared (see the module docstring)."""
    B, S = sample["batch"], sample["seq_len"]
    units, points = sample["units"], sample["points"]
    out = {"record_gap": max([record_gap(u, points) for u in units],
                             default=1.0),
           "flops_gap": max([flops_gap(u, ref.spec, B, S) for u in units],
                            default=1.0),
           "route_gap": 0.0, "loss_gap": 0.0, "grad_gap": 0.0}
    held = [u for u in units if u.get("m") is not None]
    if not held:
        out["loss_gap"] = 1.0
    for u in held:
        want = ref.step(u["seed"], B, S, sample["idx"], u["routes"])
        out["route_gap"] = max(out["route_gap"], want.route_gap)
        out["loss_gap"] = max(out["loss_gap"], _rel(u["loss"], want.loss))
        out["grad_gap"] = max(out["grad_gap"], grad_gap(u["m"], want.m))
    return out


def control(sample: Dict, ref: Reference) -> Dict[str, float]:
    """The reference with every matrix product's inputs rounded to float8
    e4m3, one precision below the configuration's bfloat16, routing by its
    own logits, in the program's place: its routing, loss and moments held
    to the reference under that routing."""
    B, S = sample["batch"], sample["seq_len"]
    out = {"route_gap": 0.0, "loss_gap": 0.0, "grad_gap": 0.0}
    for u in sample["units"]:
        if u.get("m") is None:
            continue
        low = ref.step(u["seed"], B, S, sample["idx"], None,
                       granite.Numerics(granite.fp8_e4m3))
        want = ref.step(u["seed"], B, S, sample["idx"], low.routes)
        out["route_gap"] = max(out["route_gap"], want.route_gap)
        out["loss_gap"] = max(out["loss_gap"], _rel(low.loss, want.loss))
        out["grad_gap"] = max(out["grad_gap"], grad_gap(
            {k: v.double().cpu().numpy() for k, v in low.m.items()},
            want.m))
    return out
