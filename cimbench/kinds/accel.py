"""The accel kind: Eva-CiM's accelerator-mode question asked of a model's
train step at its published widths.  A configuration is a model
(catalog keys of its ``config.json``, the cut this chip holds, its dtype);
a unit is one cold analysis of the step by the port's ``DSEEngine`` with
its ``TpuBackend`` (record the step on weights drawn from a seed, find
the fusion chains, count FLOPs and bytes), priced at every (chip,
threshold) of the mix.

The pieces are the modules beside the kind: :mod:`cimbench.accel_port`
(the traffic and the system under test), :mod:`cimbench.accel_check`
(the comparison and its limits) and :mod:`cimbench.ref_accel` (the plain
reference).  See :mod:`cimbench.kinds` for what a kind gives.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

from cimbench import accel_check, accel_port

LIMITS = accel_check.LIMITS
compare = accel_check.compare
control = accel_check.control
#: the faults of a timed path: one held expert's rows dropped, the
#: experts' rows capped at an even share (a capacity of 1.0), the step
#: recorded on zeroed weights
FAULTS = ("dropped_expert", "capacity", "zero_weights")


def build_kernels() -> Dict[str, float]:
    """The accelerator-mode path launches no kernel of the port's own."""
    return {}


def traffic(path, config: Dict, seed: int) -> accel_port.Traffic:
    return accel_port.Traffic(accel_port.load(path), config, seed)


def port(traffic, config: Dict, device: str) -> accel_port.Port:
    return accel_port.Port(traffic, config, device)


def keeps_every_unit(traffic) -> bool:
    """A unit's step outputs (sampled moments, routing) are kept for the
    last unit and one drawn; the records and analysis numbers of every
    unit are small and stay."""
    return False


def reference(config: Dict) -> accel_check.Reference:
    return accel_check.Reference(config)


def tiny_config(config: Dict) -> Dict:
    """Six layers of the pattern (five Mamba-2, one attention) at small
    widths, 2 of 16 experts held, top-4, a 512-row vocabulary, float32."""
    return dict(config, hidden_size=64, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=32,
                shared_intermediate_size=48, mamba_n_heads=8,
                mamba_d_head=16, mamba_d_state=8, mamba_chunk_size=16,
                num_hidden_layers=6, num_local_experts=2,
                num_experts_per_tok=4, vocab_size=512, experts_held=[3, 11],
                published=dict(config["published"], num_local_experts=16),
                dtype="float32")


def tiny_mix(mix: Dict) -> Dict:
    """One sequence of 64 tokens (four chunks), 16 entries a parameter."""
    return dict(mix, seq_len=64, sample_per_leaf=16)


def _capped(orig):
    """The dropless dispatch with each held expert's rows capped at an
    even share of the slots (a capacity factor of 1.0): the slots past an
    expert's capacity go to an expert this chip does not hold, that is,
    they are dropped, as a capacity-bound dispatch drops them."""
    def dispatch(params, cfg, x, idx, gates):
        T, k = idx.shape
        cap = max(1, T * k // cfg.moe.n_experts)
        absent = next(e for e in range(cfg.moe.n_experts)
                      if e not in cfg.held)
        flat = idx.reshape(-1).clone()
        for e in cfg.held:
            flat[(flat == e).nonzero().squeeze(1)[cap:]] = absent
        return orig(params, cfg, x, flat.reshape(T, k), gates)
    return dispatch


@contextlib.contextmanager
def fault(name: str):
    """Break the program's timed path for the duration."""
    from repro_torch.models import moe
    from repro_torch.train import steps
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "dropped_expert":
        orig = moe.dropless_experts

        def dropped(params, cfg, x, idx, gates):
            sub = {k: (v[:-1] if k in ("w_gate", "w_up", "w_down") else v)
                   for k, v in params.items()}
            return orig(sub, dataclasses.replace(
                cfg, experts_held=cfg.held[:-1]), x, idx, gates)
        patch(moe, "dropless_experts", dropped)
    elif name == "capacity":
        patch(moe, "dropless_experts", _capped(moe.dropless_experts))
    elif name == "zero_weights":
        init = steps.init_train_state

        def zeroed(gen, cfg, device=None):
            import torch
            state = init(gen, cfg, device=device)
            with torch.no_grad():
                for t in _leaves(state["params"]):
                    t.zero_()
            return state
        patch(steps, "init_train_state", zeroed)
    elif name != "none":
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
