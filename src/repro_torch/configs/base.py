"""Model / run configuration dataclasses: the port's copy of
``repro.configs.base``, field for field.

Frozen + hashable so a config can key a cache and two configs compare
with ``==``. One ``ModelConfig`` instance per assigned architecture
lives in ``src/repro_torch/configs/<arch>.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0
    n_shared_experts: int = 0          # shared (always-on) experts, 0 = none
    capacity_factor: float = 1.25
    impl: str = "gather"               # "gather" (argsort dispatch) | "einsum" (one-hot dispatch) | "dropless" (hybrid_moe: moe.granite_moe)
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "none"                 # "xlstm" | "mamba2"
    d_state: int = 16
    n_heads: int = 0                   # SSM heads (hymba: same count as attn heads)
    head_dim: int = 0
    chunk: int = 128                   # chunked-scan block length
    conv_dim: int = 4                  # short causal conv width (mamba)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm | hybrid_moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0            # 0 = full attention
    global_every: int = 0              # gemma3: every k-th layer is global (window=0)
    attn_logit_softcap: float = 0.0
    # --- block composition ---
    norm: str = "rms"                  # "rms" | "ln"
    tie_embeddings: bool = True
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # --- enc-dec / multimodal frontends (stubs provide embeddings) ---
    n_enc_layers: int = 0              # encdec only
    enc_len_ratio: int = 4             # encoder frames = seq_len // ratio (audio subsampling)
    n_prefix_embeds_ratio: int = 0     # vlm: patches = seq_len // ratio (prefix of the sequence)
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # --- bookkeeping ---
    source: str = ""
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128, as the reference pads its embedding."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def is_recurrent(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm_state(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic context path exists (SSM / sliding-window / local:global)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (unpadded vocab), used for 6·N·D model FLOPs."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d
        if not self.tie_embeddings:
            emb *= 2
        per_layer = 0
        # attention
        per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            per_layer += self.q_dim + 2 * self.kv_dim
        # ffn
        if self.moe.n_experts:
            e = self.moe
            per_layer += d * e.n_experts                       # router
            per_layer += 3 * d * e.expert_d_ff * (e.n_experts + e.n_shared_experts)
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff                      # SwiGLU
        # ssm side (hybrid) / xlstm extras are small; approximate where present
        if self.ssm.kind == "mamba2":
            di = self.ssm.n_heads * self.ssm.head_dim
            per_layer += d * 2 * di + di * d + di * (2 * self.ssm.d_state)
        if self.family == "ssm":
            # mLSTM blocks: up-proj 2x + qkv + gates + down-proj (dominates)
            per_layer += 2 * (d * 2 * d) + 3 * d * d // 2
        per_layer += 2 * d                                      # norms
        dec_layers = L
        total = emb + dec_layers * per_layer
        if self.n_enc_layers:
            enc_per = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + 3 * d * self.d_ff + 2 * d
            # decoder cross-attention adds one more attention block per layer
            total += self.n_enc_layers * enc_per + L * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared experts)."""
        if not self.moe.n_experts:
            return self.param_count()
        d, L, e = self.d_model, self.n_layers, self.moe
        total = self.param_count()
        all_experts = 3 * d * e.expert_d_ff * (e.n_experts + e.n_shared_experts) * L
        active = 3 * d * e.expert_d_ff * (e.top_k + e.n_shared_experts) * L
        return total - all_experts + active


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """A decoder whose mixer is chosen per layer by a pattern (Mamba-2 or
    attention) and whose every layer ends in a dropless mixture of experts
    with a shared expert, as Granite-4.0-H (``granitemoehybrid``) has it.
    A subclass, so the ten archs' configs and their reprs stay the
    reference's field for field.

    ``layer_types`` is the published pattern; the model runs its first
    ``n_layers`` entries.  ``moe.n_experts`` is the router's width; a layer
    holds the experts ``experts_held`` (all where empty) and computes only
    their part of the result, as one chip of an expert-parallel group
    does.  ``attention_multiplier`` scales the scores in place of
    1/sqrt(head_dim); ``embedding_multiplier``, ``residual_multiplier``
    and ``logits_scaling`` scale the embedding, each branch before its
    residual add, and divide the logits."""
    layer_types: Tuple[str, ...] = ()
    experts_held: Tuple[int, ...] = ()
    shared_d_ff: int = 0
    ssm_groups: int = 1
    attention_multiplier: float = 0.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    @property
    def pattern(self) -> Tuple[str, ...]:
        """The mixer of each layer that runs."""
        return self.layer_types[:self.n_layers]

    @property
    def held(self) -> Tuple[int, ...]:
        return self.experts_held or tuple(range(self.moe.n_experts))

    @property
    def ssm_inner(self) -> int:
        return self.ssm.n_heads * self.ssm.head_dim

    @property
    def conv_channels(self) -> int:
        """x, B and C, which the Mamba-2 mixer convolves together."""
        return self.ssm_inner + 2 * self.ssm_groups * self.ssm.d_state

    def param_count(self) -> int:
        """Parameters this configuration holds (held experts only)."""
        d, e, s = self.d_model, self.moe, self.ssm
        mamba = (d * (self.ssm_inner + self.conv_channels + s.n_heads)
                 + self.conv_channels * (s.conv_dim + 1) + 3 * s.n_heads
                 + self.ssm_inner + self.ssm_inner * d)
        attn = 2 * d * self.q_dim + 2 * d * self.kv_dim
        moe = (d * e.n_experts + 3 * d * e.expert_d_ff * len(self.held)
               + 3 * d * self.shared_d_ff)
        per_kind = {"mamba": mamba, "attention": attn}
        return (self.padded_vocab * d + d
                + sum(per_kind[t] + moe + 2 * d for t in self.pattern))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    # distributed-optimization knobs
    remat: str = "block"               # "none" | "block" | "full"
    grad_compression: str = "none"     # "none" | "bf16" | "int8_ef"
    microbatches: int = 1              # gradient accumulation
    zero1: bool = True                 # shard optimizer state over the data axis
