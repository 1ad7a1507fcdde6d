"""The reference's training outputs that the port is held to, where JAX is
absent (the card's machine).

``models/fixtures/reference_train.json`` holds, for each case of
:func:`train_cases`, what the reference's ``make_train_step`` computes from
``convert.numpy_params(cfg, SEED_PARAMS)`` and one numpy batch
(:func:`numpy_train_batch`): per step the metrics ``loss``, ``aux_loss``,
``grad_norm`` and ``lr``, and after the last step every
``param_stride``-th entry of each parameter leaf (flattened, in sorted path
order).  ``tests/test_torch_train.py --regenerate`` writes it; the test
file and ``chip_smoke.py`` phase 12 hold the port to it with
:func:`compare`.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.models import convert
from repro_torch.models.fixtures import _f32
from repro_torch.optim import adamw
from repro_torch.optim.compression import init_error_feedback
from repro_torch.optim.tree import leaves_with_path
from repro_torch.train.steps import make_train_step

FIXTURE = pathlib.Path(convert.__file__).resolve().parent / "fixtures" / \
    "reference_train.json"
SEED_PARAMS = 0
SEED_INPUTS = 1
SEED_LABELS = 2
SEED_NOISE = 3
METRICS = ("loss", "aux_loss", "grad_norm", "lr")
# |port - reference| / |reference| on each step's metrics, f32 on both
# sides: at least METRIC_RTOL, and SPREAD_FACTOR times what the
# reference's own metric moves when its parameters start one f32 ulp away
# (``self_spread``, recorded per case and step).  Most metrics move below
# 1e-6; hymba's grad_norm is ill-conditioned (its gradient at step 3 moves
# 3.7e-4 under that noise, and the port's CPU miss is 5.6e-4)
METRIC_RTOL = 1e-4
SPREAD_FACTOR = 10
# an AdamW step moves an element by lr * |m_hat / (sqrt(v_hat) + eps)|,
# and over the first three steps |m_hat| <= 1.01 sqrt(v_hat): two runs
# whose gradients differ only in rounding end at most this many times the
# summed learning rate apart (where |g| is near eps, the rounding decides
# the sign); the misses measured on the CPU are below 0.02 of it
ADAM_STEP_BOUND = 2.05


@dataclasses.dataclass(frozen=True)
class TrainCase:
    name: str
    cfg: ModelConfig
    tc: TrainConfig
    batch: int
    seq_len: int
    steps: int
    param_stride: int


def train_cases() -> List[TrainCase]:
    """The ten reduced archs (B=2, S=32, 3 steps); qwen1.5-0.5b reduced
    with two microbatches and int8 error-feedback compression, and with
    remat "block"; gemma3-1b at its published widths cut to 6 layers (five
    local layers of window 512 and one global), B=1, S=576 (longer than
    the window), 2 steps.  All f32, ``warmup_steps=1``."""
    tc = TrainConfig(remat="none", warmup_steps=1)
    cases = [TrainCase(a, _f32(reduced_config(a)), tc, 2, 32, 3, 61)
             for a in sorted(ARCHS)]
    q = _f32(reduced_config("qwen1.5-0.5b"))
    cases.append(TrainCase(
        "qwen1.5-0.5b@mb2-int8_ef", q, dataclasses.replace(
            tc, microbatches=2, grad_compression="int8_ef"), 2, 32, 3, 61))
    cases.append(TrainCase("qwen1.5-0.5b@remat-block", q,
                           dataclasses.replace(tc, remat="block"),
                           2, 32, 3, 61))
    g = dataclasses.replace(_f32(get_config("gemma3-1b")), n_layers=6)
    cases.append(TrainCase("gemma3-1b@6L", g, tc, 1, 576, 2, 4093))
    return cases


def numpy_train_batch(cfg: ModelConfig, batch: int, seq_len: int):
    """``convert.numpy_batch`` from ``SEED_INPUTS`` plus int32 labels for
    every position (B, seq_len), drawn from ``SEED_LABELS``."""
    out = convert.numpy_batch(cfg, batch, seq_len, SEED_INPUTS)
    out["labels"] = np.random.default_rng(SEED_LABELS).integers(
        0, cfg.vocab_size, (batch, seq_len), dtype=np.int32)
    return out


def initial_state(params, case: TrainCase):
    """The train state both packages start from: ``params``, zero moments,
    step 0, and zero error feedback under ``int8_ef``."""
    state = {"params": params, "opt": adamw.init_moments(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=params["embed"].device)}
    if case.tc.grad_compression == "int8_ef":
        state["error_fb"] = init_error_feedback(params)
    return state


def train_run(params, case: TrainCase, device=None):
    """``case.steps`` train steps of the port on ``device``.  Returns
    ([metrics per step, floats], the final parameter tree)."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             numpy_train_batch(case.cfg, case.batch, case.seq_len).items()}
    step = make_train_step(case.cfg, case.tc)
    state = initial_state(params, case)
    metrics = []
    for _ in range(case.steps):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in METRICS})
    return metrics, state["params"]


def ulp_noise(tree, seed: int = SEED_NOISE):
    """A numpy tree with every entry moved by one f32 ulp (2**-23 of
    itself) up or down at random: the start of the ``self_spread`` run."""
    rng = np.random.default_rng(seed)
    up = np.float32(1 + 2.0 ** -23)
    down = np.float32(1 - 2.0 ** -23)

    def move(node):
        if isinstance(node, dict):
            return {k: move(node[k]) for k in sorted(node)}
        a = np.asarray(node, np.float32)
        return a * np.where(rng.random(a.shape) < 0.5, down, up)
    return move(tree)


def spread(metrics, noisy) -> List[Dict[str, float]]:
    """Per step and metric, |noisy - metrics| / |metrics|."""
    return [{k: abs(b[k] - a[k]) / max(abs(a[k]), 1e-30) for k in METRICS}
            for a, b in zip(metrics, noisy)]


def strided(tree, stride: int) -> Dict[str, np.ndarray]:
    """Every ``stride``-th entry of each leaf (tensors or numpy arrays),
    flattened, as float32."""
    out = {}
    for path, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float().cpu().numpy()
        out[path] = np.asarray(leaf, np.float32).reshape(-1)[::stride]
    return out


def record(case: TrainCase, metrics, params, self_spread) -> Dict:
    """One case's fixture entry from a run's metrics and final parameters
    (either package's tree) and the reference's own :func:`spread`."""
    return {"arch": case.cfg.arch_id, "n_layers": case.cfg.n_layers,
            "batch": case.batch, "seq_len": case.seq_len,
            "steps": case.steps, "param_stride": case.param_stride,
            "train_config": dataclasses.asdict(case.tc),
            "metrics": [{k: float(str(np.float32(m[k]))) for k in METRICS}
                        for m in metrics],
            "self_spread": [{k: float(f"{v:.3g}") for k, v in sp.items()}
                            for sp in self_spread],
            "params": {p: [float(str(v)) for v in a]
                       for p, a in strided(params, case.param_stride).items()}}


def metric_tol(entry: Dict, step: int, k: str) -> float:
    return max(METRIC_RTOL, SPREAD_FACTOR * entry["self_spread"][step][k])


def compare(entry: Dict, metrics, params) -> Dict:
    """A run against its fixture entry: each step's metrics within
    :func:`metric_tol`, the stored parameter entries within
    ``ADAM_STEP_BOUND`` times the reference's summed learning rate."""
    metric_share = 0.0
    for i, (got, want) in enumerate(zip(metrics, entry["metrics"])):
        for k in METRICS:
            metric_share = max(metric_share, abs(got[k] - want[k])
                               / max(abs(want[k]), 1e-30)
                               / metric_tol(entry, i, k))
    have = strided(params, entry["param_stride"])
    param_err = 0.0
    same_leaves = sorted(have) == sorted(entry["params"])
    for path, want in entry["params"].items():
        if path in have and have[path].size == len(want):
            param_err = max(param_err, float(np.abs(
                have[path] - np.asarray(want, np.float32)).max(initial=0.0)))
        else:
            same_leaves = False
    param_tol = ADAM_STEP_BOUND * sum(m["lr"] for m in entry["metrics"])
    ok = (same_leaves and len(metrics) == len(entry["metrics"])
          and metric_share <= 1.0 and param_err <= param_tol)
    return {"metric_share_of_tol": metric_share,
            "param_max_abs_err": param_err, "param_tol": param_tol,
            "share_of_tol": max(metric_share, param_err / param_tol),
            "losses": [m["loss"] for m in metrics], "ok": ok}


def load() -> Dict:
    return json.loads(FIXTURE.read_text())
