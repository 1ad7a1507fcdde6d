"""String processing (Table IV): longest common subsequence -- the paper's
validation workload (section VI-A compares offload counts on LCS).

Twin of ``repro/workloads/strings.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.trace import scan
from repro_torch.workloads.lowering import I32, astype, imm, take


def build_lcs(scale: int = 1):
    """Classic O(n*m) DP:  dp[i,j] = a_i==b_j ? dp[i-1,j-1]+1
                                              : max(dp[i-1,j], dp[i,j-1]).

    Integer adds / max / compares over the DP row -- the canonical
    Load-Load-OP-Store workload."""
    r = np.random.default_rng(5)
    n = m = 24 * scale
    a = torch.from_numpy(r.integers(0, 4, (n,)).astype(np.int32))
    b = torch.from_numpy(r.integers(0, 4, (m,)).astype(np.int32))

    def lcs(a, b):
        row0 = torch.zeros((m + 1,), dtype=I32)

        def outer(prev_row, ai):
            def inner(carry, j):
                left = carry                       # dp[i, j-1]
                up = take(prev_row, j)             # dp[i-1, j]
                diag = take(prev_row, j - 1)       # dp[i-1, j-1]
                match = astype(ai == take(b, j - 1), I32)
                val = torch.maximum(torch.maximum(up, left), diag + match)
                return val, val
            _, tail = scan(inner, imm(0), imm(1) + torch.arange(m, dtype=I32))
            row = torch.cat([torch.zeros((1,), dtype=I32), tail])
            return row, None

        final, _ = scan(outer, row0, a)
        return final[m]

    return lcs, (a, b)
