"""hymba-1.5b — parallel attention + mamba heads in every block.

[arXiv:2411.13676; hf]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Attention is sliding-window (Hymba uses SWA in all but 3 layers; we use SWA
everywhere + the SSM path for global reach — noted reduction).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    sliding_window=1024,
    tie_embeddings=True,
    ssm=SSMConfig(kind="mamba2", d_state=16, n_heads=25, head_dim=64, chunk=128),
    source="arXiv:2411.13676",
    notes=("Meta tokens omitted (stub-level feature). vocab 32001 padded to "
           "32128 in the embedding for shard/MXU alignment."),
)
