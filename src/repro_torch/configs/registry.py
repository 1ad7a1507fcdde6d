"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

``ARCHS`` holds the ten archs that the tests hold to the reference
package; ``PUBLISHED`` the configurations that run at their published
widths only in the port (granite-4.0-h-small and its named cuts), which
:func:`get_config` and :func:`reduced_config` resolve too."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (HybridMoEConfig, ModelConfig,
                                      MoEConfig, SSMConfig)
from repro_torch.configs import granite_4_0_h_small
from repro_torch.configs import (
    llama4_scout_17b_a16e, moonshot_v1_16b_a3b, xlstm_125m, hymba_1_5b,
    qwen1_5_0_5b, gemma3_1b, yi_34b, phi4_mini_3_8b, seamless_m4t_large_v2,
    pixtral_12b,
)

_MODULES = (
    llama4_scout_17b_a16e, moonshot_v1_16b_a3b, xlstm_125m, hymba_1_5b,
    qwen1_5_0_5b, gemma3_1b, yi_34b, phi4_mini_3_8b, seamless_m4t_large_v2,
    pixtral_12b,
)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}
PUBLISHED: Dict[str, ModelConfig] = {
    c.arch_id: c for c in granite_4_0_h_small.CONFIGS}


def get_config(arch_id: str) -> ModelConfig:
    cfg = ARCHS.get(arch_id) or PUBLISHED.get(arch_id)
    if cfg is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(ARCHS) + sorted(PUBLISHED)}")
    return cfg


def reduced_config(arch_id: str) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests.

    Small layers/width/experts/vocab — same block structure, same code paths.
    """
    cfg = get_config(arch_id)
    if isinstance(cfg, HybridMoEConfig):
        return granite_4_0_h_small.reduced(cfg)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    # keep GQA grouping valid: heads must be a multiple of kv heads
    n_heads = (n_heads // n_kv) * n_kv or n_kv
    small = dict(
        n_layers=2 if cfg.family != "ssm" else 2,   # ssm: one mLSTM + one sLSTM
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        global_every=cfg.global_every if cfg.global_every else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
    )
    if cfg.moe.n_experts:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), expert_d_ff=64)
    if cfg.ssm.kind != "none":
        small["ssm"] = dataclasses.replace(
            cfg.ssm, n_heads=n_heads, head_dim=16, d_state=8, chunk=16)
    return dataclasses.replace(cfg, **small)
