"""Train-step and serve-step factories (port of ``repro.train.steps``).

``make_train_step(cfg, tc)`` returns ``step(state, batch) -> (state,
metrics)``: the loss's gradients from autograd (each in its parameter's
dtype, as ``jax.grad`` gives them; with ``microbatches > 1`` summed in f32
and divided at the end), then compression, then AdamW.  The state is a
tree of tensors and each step returns a new one; no tensor of the old
state is written.  ``make_prefill_step`` / ``make_decode_step`` return the
functions the serving driver calls: greedy ``argmax`` over the padded
vocab, int32 tokens.  The decode step updates the cache in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.dist.sharding import unshard_dim
from repro_torch.models.transformer import (forward_decode, forward_full,
                                            init_params, lm_loss)
from repro_torch.optim import adamw, compression
from repro_torch.optim.tree import leaves, tree_map


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     device=None) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` (which must live on ``device``), zero
    moments and an int32 step counter."""
    params = init_params(gen, cfg, device=device)
    return {"params": params, "opt": adamw.init_moments(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def loss_fn(params, cfg: ModelConfig, batch, *, remat: str = "none"):
    logits, aux, _ = forward_full(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    # next-token shift: predict labels[t] from logits[t-1]; here labels are
    # pre-shifted by the pipeline, so align lengths only (VLM prefix).
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    loss = lm_loss(logits, labels, cfg.padded_vocab)
    return loss + 0.01 * aux, (loss, aux)


def grads_and_loss(params, cfg: ModelConfig, batch, *, remat: str = "none"):
    """``jax.grad(loss_fn, has_aux=True)``: (grads, loss, aux), the grads a
    tree like ``params``; a parameter the loss does not reach gets zeros."""
    req = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, (loss, aux) = loss_fn(req, cfg, batch, remat=remat)
    flat = leaves(req)
    got = torch.autograd.grad(total, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, got))
    return tree_map(lambda _: next(it), req), loss.detach(), aux.detach()


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    def train_step(state, batch):
        params = state["params"]
        if tc.microbatches > 1:
            mb = tc.microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            dev = state["step"].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                g, l, a = grads_and_loss(params, cfg, part, remat=tc.remat)
                grads = tree_map(torch.add, grads, g)
                loss, aux = loss + l, aux + a
            grads = tree_map(lambda g: g / mb, grads)
            loss, aux = loss / mb, aux / mb
        else:
            grads, loss, aux = grads_and_loss(params, cfg, batch,
                                              remat=tc.remat)
        with torch.no_grad():
            efb = state.get("error_fb")
            grads, efb = compression.compress_grads(
                grads, tc.grad_compression, efb)
            new_params, new_opt, om = adamw.adamw_update(
                params, grads, state["opt"], state["step"], tc)
        new_state = dict(state, params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        if efb is not None:
            new_state["error_fb"] = efb
        return new_state, {"loss": loss, "aux_loss": aux, **om}

    return train_step


def _whole_vocab(logits):
    """The last position's logits with the vocab dim gathered where a mesh
    splits it (DTensor's argmax over a split dim fails on a one-row
    shard), so the greedy pick reads every logit."""
    return unshard_dim(logits, logits.ndim - 1)


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        logits, _, cache = forward_full(params, cfg, batch, collect_cache=True,
                                        cache_len=cache_len)
        next_tok = torch.argmax(_whole_vocab(logits[:, -1:]),
                                dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache, cur_pos: int):
        logits, cache = forward_decode(params, cfg, token, cache, cur_pos)
        next_tok = torch.argmax(_whole_vocab(logits[:, -1]), dim=-1,
                                keepdim=True).to(torch.int32)
        return next_tok, cache

    return decode_step
