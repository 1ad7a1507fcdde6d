"""Model input construction for serving and the smoke runs (port of
``repro.models.inputs``).

Modality frontends are stubs, as in the reference: ``encdec`` archs
receive precomputed frame embeddings and ``vlm`` archs patch embeddings.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
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


def make_decode_inputs(gen: torch.Generator, cfg: ModelConfig, batch: int,
                       max_len: int, cur_pos: int, device=None):
    token = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                          dtype=torch.int32, device=device)
    cache = init_cache(cfg, batch, max_len, device=device)
    return {"token": token, "cache": cache, "cur_pos": int(cur_pos)}
