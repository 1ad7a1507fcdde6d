"""granite-4.0-h-small — Mamba-2 and attention layers by pattern, each
followed by a dropless mixture of experts with a shared expert.

[hf:ibm-granite/granite-4.0-h-small, config.json; ``granitemoehybrid``]
40L (36 Mamba-2, attention at layers 5, 15, 25, 35) d_model=4096;
Mamba-2 128 heads x 64, d_state 128, 1 group, conv 4, chunk 256;
attention GQA 32/8, head 128, no position embedding (NoPE), scores scaled
by ``attention_multiplier`` 1/128; 72 experts of width 768, top-10
(top-k over the logits, then softmax over those k), a shared expert of
width 1536; embedding x12, each residual branch x0.22, logits / 16; tied
embeddings, vocab 100,352; RMSNorm eps 1e-5.

``CONFIG`` is the published model.  ``EP8`` is the named cut
``granite-4.0-h-small-ep8``: one chip of a deployment in which eight
chips share each layer (experts 8 ways, 9 a chip; mixers and the shared
expert replicated) and the 40 layers form four pipeline stages of ten.
It keeps the first period of the pattern (``layer_types[0:10]``: five
Mamba-2, one attention, four Mamba-2), the experts 0-8 of the router's
72 and an eighth of the vocabulary (rows 0-12,543).  No width is cut.
"""
import dataclasses

from repro_torch.configs.base import HybridMoEConfig, MoEConfig, SSMConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = HybridMoEConfig(
    arch_id="granite-4.0-h-small",
    family="hybrid_moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=100_352,
    norm_eps=1e-5,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=72, top_k=10, expert_d_ff=768,
                  n_shared_experts=1, capacity_factor=0.0,
                  impl="dropless"),
    ssm=SSMConfig(kind="mamba2", d_state=128, n_heads=128, head_dim=64,
                  chunk=256, conv_dim=4),
    layer_types=_PERIOD + ("mamba",) * 5 + ("attention",)
    + (("mamba",) * 9 + ("attention",)) * 2 + ("mamba",) * 4,
    shared_d_ff=1536,
    ssm_groups=1,
    attention_multiplier=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json",
    notes=("The load-balancing loss is the port's Switch-style loss at "
           "0.01 (config.json gives none); no capacity: dispatch is "
           "dropless."),
)

#: eight chips share each layer; this chip holds experts 0-8
EP8 = dataclasses.replace(
    CONFIG, arch_id="granite-4.0-h-small-ep8", n_layers=10,
    vocab_size=100_352 // 8, experts_held=tuple(range(9)))

CONFIGS = (CONFIG, EP8)


def reduced(cfg: HybridMoEConfig) -> HybridMoEConfig:
    """The CPU smoke cut: one Mamba-2 and one attention layer, small
    widths, 8 experts (top-2, all held) and a 512-row vocabulary; the
    multipliers and the routing stay."""
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        vocab_size=512, layer_types=("mamba", "attention"),
        experts_held=(), shared_d_ff=48,
        moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                expert_d_ff=32),
        ssm=dataclasses.replace(cfg.ssm, n_heads=4, head_dim=16, d_state=8,
                                chunk=16))
