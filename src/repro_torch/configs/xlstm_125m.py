"""xlstm-125m — sLSTM + mLSTM blocks (attention-free). [arXiv:2405.04517]

12L d_model=768 4H d_ff=0 vocab=50304. Alternating mLSTM/sLSTM pairs
(6x[mLSTM, sLSTM]); mLSTM blocks carry the up-projection (d_ff=0 means no
separate FFN, as in the paper's block design).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    tie_embeddings=True,
    ssm=SSMConfig(kind="xlstm", n_heads=4, head_dim=192, chunk=128),
    source="arXiv:2405.04517 (unverified)",
    notes="O(1)-state decode: long_500k runs on the recurrent path.",
)
