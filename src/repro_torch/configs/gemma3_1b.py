"""gemma3-1b — dense, 5:1 local:global attention, 128k-class context.

[hf:google/gemma-3-1b-pt; unverified]
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256,
sliding_window=512 on local layers, every 6th layer global.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    sliding_window=512,
    global_every=6,
    rope_theta=1_000_000.0,
    attn_logit_softcap=0.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt (unverified)",
    notes=("long_500k runs: 5 of 6 layers are windowed; global layers keep "
           "full KV (kv=1 head, sequence-sharded) — see DESIGN.md."),
)
