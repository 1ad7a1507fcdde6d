"""pixtral-12b — pixtral-ViT frontend + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
Backbone only: the ViT frontend is a STUB — ``input_specs()`` provides
precomputed patch embeddings occupying the first seq_len//4 positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    n_prefix_embeds_ratio=4,
    source="hf:mistralai/Pixtral-12B-2409 (unverified)",
)
