"""llama4-scout-17b-a16e — MoE, 16 experts top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=16, top_k=1, expert_d_ff=8192,
                  n_shared_experts=0, capacity_factor=1.25, impl="einsum"),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
    notes=("Assignment lists 16e top-1 only; the HF release also has a shared "
           "expert + interleaved dense layers which we omit to match the "
           "assigned spec exactly. Baseline MoE dispatch is one-hot einsum "
           "(GShard-style) — the beyond-paper hillclimb switches to gather."),
)
