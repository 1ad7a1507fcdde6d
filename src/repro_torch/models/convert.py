"""Carry parameters, inputs and caches between the reference and the port.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, and the card may have no JAX.  So both packages are fed one
tree drawn with numpy: ``numpy_params(cfg, seed)`` fills the layout that
``reference_param_shapes(cfg)`` states (the port's own copy of the
reference's pytree), and ``from_reference`` maps such a tree -- or the
reference's own parameters or caches, as numpy arrays -- onto the port's
tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.inputs import _text_len
from repro_torch.models.layers import Leaf
from repro_torch.models.transformer import param_layout

# a constant leaf (norm weight, bias, gate bias) is drawn as its init value
# plus this much noise, so a dropped or misplaced one changes the output
CONST_NOISE = 0.02


def _walk(node, fn):
    if isinstance(node, dict):
        return {k: _walk(node[k], fn) for k in sorted(node)}
    return fn(node)


def reference_param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree as (shape, dtype name) leaves."""
    return _walk(param_layout(cfg), lambda leaf: (leaf.shape, leaf.dtype))


def numpy_params(cfg: ModelConfig, seed: int) -> Dict[str, Any]:
    """Every leaf of the reference's tree drawn from
    ``np.random.default_rng(seed)`` in float32, in sorted path order: a
    normal scaled as ``dense_init`` / ``embed_init`` scale it, or a
    constant leaf's value plus ``CONST_NOISE`` times a normal.  bf16 leaves
    are returned in float32; each package rounds them on the way in."""
    rng = np.random.default_rng(seed)

    def draw(leaf: Leaf):
        z = rng.standard_normal(leaf.shape, dtype=np.float32)
        if leaf.init == "const":
            return np.broadcast_to(leaf.value, leaf.shape) + \
                np.float32(CONST_NOISE) * z
        z *= np.float32(leaf.scale)
        return z
    return _walk(param_layout(cfg), draw)


def numpy_batch(cfg: ModelConfig, batch: int, seq_len: int,
                seed: int) -> Dict[str, np.ndarray]:
    """A prefill batch as ``make_train_batch`` shapes it, drawn with numpy:
    int32 tokens and float32 stub embeddings."""
    rng = np.random.default_rng(seed)
    St = _text_len(cfg, seq_len)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, St),
                                  dtype=np.int32)}
    if cfg.family == "encdec":
        Se = max(1, seq_len // cfg.enc_len_ratio)
        out["enc_embeds"] = rng.standard_normal((batch, Se, cfg.d_model),
                                                dtype=np.float32)
    if cfg.family == "vlm" and St < seq_len:
        out["prefix_embeds"] = rng.standard_normal(
            (batch, seq_len - St, cfg.d_model), dtype=np.float32)
    return out


def _tensor(x, device) -> torch.Tensor:
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:                # a jax array's host view
        a = a.copy()
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_reference(cfg: ModelConfig, tree, device=None):
    """A reference tree of arrays as the port's tensors on ``device``.

    A parameter tree (it has ``embed``) is checked leaf by leaf against
    the reference's layout and cast to each leaf's dtype; any other tree
    (a prefill cache, a decode cache) keeps its dtypes."""
    if "embed" not in tree:
        return _walk(tree, lambda a: _tensor(a, device))
    layout = param_layout(cfg)

    def conv(path, node, spec):
        if isinstance(spec, Leaf):
            t = _tensor(node, device)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"{path}: shape {tuple(t.shape)} where the "
                                 f"reference's layout has {spec.shape}")
            return t.to(spec.torch_dtype)
        if set(node) != set(spec):
            raise ValueError(f"{path or 'params'}: keys {sorted(node)} where "
                             f"the reference's layout has {sorted(spec)}")
        return {k: conv(f"{path}/{k}", node[k], spec[k]) for k in sorted(spec)}
    return conv("", tree, layout)


def to_numpy(tree):
    """A tree of tensors as numpy arrays; floats as float32 (exact for
    bf16)."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return _walk(tree, conv)
