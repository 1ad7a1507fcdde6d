"""moonshot-v1-16b-a3b — kimi/moonlight, MoE 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    rope_theta=50_000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, expert_d_ff=1408,
                  n_shared_experts=0, capacity_factor=1.3, impl="gather"),
    source="hf:moonshotai/Moonlight-16B-A3B",
    notes=("Moonlight additionally uses 2 shared experts and a dense first "
           "layer; assignment lists 64e top-6 only, which we follow. "
           "k=6 makes one-hot dispatch tensors prohibitive -> gather impl."),
)
