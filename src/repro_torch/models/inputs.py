"""Model input construction: concrete batches for serving and the smoke
runs, and shape-and-dtype stand-ins for the dry run, which allocate
nothing (port of ``repro.models.inputs``).

Modality frontends are stubs, as in the reference: ``encdec`` archs
receive precomputed frame embeddings and ``vlm`` archs patch embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import init_cache


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text positions for VLM (rest of the sequence is the patch prefix)."""
    if cfg.family == "vlm" and cfg.n_prefix_embeds_ratio:
        return seq_len - seq_len // cfg.n_prefix_embeds_ratio
    return seq_len


def prefix_len(cfg: ModelConfig, seq_len: int) -> int:
    return seq_len - _text_len(cfg, seq_len)


def make_train_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                     seq_len: int, device=None) -> Dict[str, Any]:
    """Random tokens and labels (int32) and the stub embeddings (bf16),
    drawn from ``gen``, which must live on ``device``."""
    St = _text_len(cfg, seq_len)
    ints = dict(generator=gen, dtype=torch.int32, device=device)
    out = {
        "tokens": torch.randint(0, cfg.vocab_size, (batch, St), **ints),
        "labels": torch.randint(0, cfg.vocab_size, (batch, seq_len), **ints),
    }

    def normal(n):
        return torch.randn((batch, n, cfg.d_model), generator=gen,
                           device=device).to(torch.bfloat16)
    if cfg.family == "encdec":
        out["enc_embeds"] = normal(max(1, seq_len // cfg.enc_len_ratio))
    if cfg.family == "vlm" and St < seq_len:
        out["prefix_embeds"] = normal(seq_len - St)
    return out


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype with no storage (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def dtype_name(self) -> str:
        """The dtype as numpy / jax names it (``int32``, ``bfloat16``)."""
        return str(self.dtype).removeprefix("torch.")

    @classmethod
    def of(cls, t: torch.Tensor) -> "TensorSpec":
        return cls(tuple(int(d) for d in t.shape), t.dtype)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    St = _text_len(cfg, S)
    specs = {
        "tokens": TensorSpec((B, St), torch.int32),
        "labels": TensorSpec((B, S), torch.int32),
    }
    if cfg.family == "encdec":
        Se = max(1, S // cfg.enc_len_ratio)
        specs["enc_embeds"] = TensorSpec((B, Se, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm" and St < S:
        specs["prefix_embeds"] = TensorSpec((B, S - St, cfg.d_model),
                                            torch.bfloat16)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    specs = train_input_specs(cfg, shape)
    specs.pop("labels")
    return specs


def cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """:func:`init_cache`'s tree as :class:`TensorSpec` leaves, built on
    the meta device (no storage)."""
    from repro_torch.optim.tree import tree_map
    return tree_map(TensorSpec.of, init_cache(cfg, batch, max_len,
                                              device="meta"))


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """One-token step: token + cache-of-length-seq_len."""
    B, S = shape.global_batch, shape.seq_len
    return {
        "token": TensorSpec((B, 1), torch.int32),
        "cache": cache_spec(cfg, B, S),
        "cur_pos": TensorSpec((), torch.int32),
    }


def make_decode_inputs(gen: torch.Generator, cfg: ModelConfig, batch: int,
                       max_len: int, cur_pos: int, device=None):
    token = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                          dtype=torch.int32, device=device)
    cache = init_cache(cfg, batch, max_len, device=device)
    return {"token": token, "cache": cache, "cur_pos": int(cur_pos)}
