"""seamless-m4t-large-v2 — encoder-decoder, multimodal. [arXiv:2308.11596; hf]

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
Transformer backbone only: the speech frontend is a STUB — ``input_specs()``
provides precomputed frame embeddings (B, seq//4, d) to the 24L encoder;
the 24L decoder consumes text tokens with cross-attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    norm="ln",
    tie_embeddings=True,
    n_enc_layers=24,
    enc_len_ratio=4,
    source="arXiv:2308.11596",
    notes="vocab padded to 256256 for shard alignment.",
)
