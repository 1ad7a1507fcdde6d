"""The matrix-product FLOPs of one Granite-4.0-H train step, counted from
the widths and the routing, whatever implements the step: the yardstick
of ``step_mfu.accel`` and the check's count of the recorded graph.

The forward count is 2 M N K over the model's products: every projection,
the router over all of its experts, each held expert over the rows routed
to it, the shared expert, the tied head; causal attention over the
lower triangle (Q K^T and P V); and the SSD as the Mamba-2 paper's
minimal listing computes it per chunk of ``chunk`` rows (C B^T once for
the one group, the masked products with X, each chunk's state and the
state's output).  A step is three forwards: the forward and a backward of
twice its products.  A recomputation (remat), masked blocks an
implementation computes and drops, and bookkeeping products are not
work of the model and are not counted.
"""
from __future__ import annotations

from typing import Sequence

from cimbench.ref_accel.granite import Spec


def forward_flops(spec: Spec, batch: int, seq_len: int,
                  held_rows: Sequence[int]) -> float:
    """Forward matrix-product FLOPs; ``held_rows[i]``: the rows layer
    ``i`` sent to held experts."""
    T, d = batch * seq_len, spec.d_model
    H, P, N, K = spec.ssm_heads, spec.ssm_head_dim, spec.d_state, spec.chunk
    di, cc = spec.ssm_inner, spec.conv_channels
    chunks = -(-seq_len // K)
    total = 0.0
    for kind, rows in zip(spec.pattern, held_rows):
        if kind == "mamba":
            total += 2.0 * T * d * (di + cc + H) + 2.0 * T * di * d
            per_chunk = (2.0 * K * K * N + 2.0 * K * K * H * P
                         + 2 * 2.0 * K * H * P * N)
            total += batch * chunks * per_chunk
        else:
            q, kv = spec.n_heads * spec.head_dim, spec.n_kv_heads * spec.head_dim
            total += 2.0 * T * d * (2 * q + 2 * kv)
            pairs = seq_len * (seq_len + 1) / 2
            total += 2 * 2.0 * batch * pairs * spec.n_heads * spec.head_dim
        total += 2.0 * T * d * spec.router_experts
        total += 2.0 * rows * 3 * d * spec.expert_ff
        total += 2.0 * T * 3 * d * spec.shared_ff
    return total + 2.0 * T * d * spec.padded_vocab


def step_flops(spec: Spec, batch: int, seq_len: int,
               held_rows: Sequence[int]) -> float:
    """A train step's: the forward's three times."""
    return 3.0 * forward_flops(spec, batch, seq_len, held_rows)
