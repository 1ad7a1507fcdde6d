"""Serve-step factories (port of the serving half of ``repro.train.steps``).

``make_prefill_step`` / ``make_decode_step`` return the functions the
serving driver calls: greedy ``argmax`` over the padded vocab, int32
tokens.  The decode step updates the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward_decode, forward_full


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        logits, _, cache = forward_full(params, cfg, batch, collect_cache=True,
                                        cache_len=cache_len)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache, cur_pos: int):
        logits, cache = forward_decode(params, cfg, token, cache, cur_pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1,
                                keepdim=True).to(torch.int32)
        return next_tok, cache

    return decode_step
