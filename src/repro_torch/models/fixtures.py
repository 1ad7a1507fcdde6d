"""The reference's serving outputs that the port is held to, where JAX is
absent (the card's machine).

``fixtures/reference_serve.json`` holds, for each case of
:func:`serve_cases`, what the reference computes from
``convert.numpy_params(cfg, SEED_PARAMS)`` and
``convert.numpy_batch(cfg, B, S, SEED_INPUTS)``: the greedy tokens of the
prefill and of each decode step, and the last position's logits after
each of them (all of them for the reduced archs; for the full-width case
every ``LOGIT_STRIDE``-th entry and the reference's top ``TOP`` entries).
``tests/test_torch_serve.py --regenerate`` writes it; the test file and
``chip_smoke.py`` phase 11 hold the port to it with :func:`compare`.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.models import convert
from repro_torch.models.transformer import forward_decode, forward_full

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / \
    "reference_serve.json"
SEED_PARAMS = 0
SEED_INPUTS = 1
# |port - reference| on the stored logits, f32 on both sides: the two sum
# the same f32 terms in other orders (misses measured on the CPU: below
# 1e-5 on logits of magnitude up to 4)
LOGITS_TOL = 1e-4
LOGIT_STRIDE = 512
TOP = 8


@dataclasses.dataclass(frozen=True)
class ServeCase:
    name: str
    cfg: ModelConfig
    batch: int
    prompt_len: int
    steps: int
    full_logits: bool        # store every logit, else a stride and the top


def _f32(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def serve_cases() -> List[ServeCase]:
    """The ten reduced archs (B=2, S=32, 4 decode steps) and gemma3-1b at
    its published widths cut to 6 layers (five local layers of window 512
    and one global), B=1, a 576-token prompt (longer than the window), 4
    decode steps; all in f32."""
    cases = [ServeCase(a, _f32(reduced_config(a)), 2, 32, 4, True)
             for a in sorted(ARCHS)]
    g = dataclasses.replace(_f32(get_config("gemma3-1b")), n_layers=6)
    cases.append(ServeCase("gemma3-1b@6L", g, 1, 576, 4, False))
    return cases


def greedy_run(params, case: ServeCase, device=None):
    """Prefill and ``case.steps`` greedy decode steps on ``device``, as
    ``make_prefill_step`` / ``make_decode_step`` compute them.  Returns
    (tokens (B, 1+steps) int32, [last-position logits (B, V) float32 per
    step]) as numpy arrays."""
    cfg, S = case.cfg, case.prompt_len
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             convert.numpy_batch(cfg, case.batch, S, SEED_INPUTS).items()}
    with torch.inference_mode():
        logits, _, cache = forward_full(params, cfg, batch, collect_cache=True,
                                        cache_len=S + case.steps)
        last = [logits[:, -1].float().cpu().numpy()]
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks = [tok]
        for i in range(case.steps):
            logits, cache = forward_decode(params, cfg, tok, cache, S + i)
            last.append(logits[:, -1].float().cpu().numpy())
            tok = torch.argmax(logits[:, -1], dim=-1,
                               keepdim=True).to(torch.int32)
            toks.append(tok)
    return torch.cat(toks, dim=1).cpu().numpy(), last


def record(case: ServeCase, tokens, logits) -> Dict:
    """One case's fixture entry from a run's tokens and logits."""
    steps = []
    for lg in logits:
        rows = []
        for row in np.asarray(lg, np.float32):
            if case.full_logits:
                idx = np.arange(row.size)
            else:
                top = np.argsort(-row, kind="stable")[:TOP]
                idx = np.union1d(np.arange(0, row.size, LOGIT_STRIDE), top)
            rows.append({"index": idx.tolist() if not case.full_logits
                         else None,
                         "value": [float(str(v)) for v in row[idx]]})
        steps.append(rows)
    return {"arch": case.cfg.arch_id, "n_layers": case.cfg.n_layers,
            "batch": case.batch, "prompt_len": case.prompt_len,
            "decode_steps": case.steps,
            "tokens": np.asarray(tokens).tolist(), "logits": steps}


def compare(entry: Dict, tokens, logits) -> Dict:
    """A run against its fixture entry: tokens ==, and the largest
    |port - reference| over the stored logits beside ``LOGITS_TOL``."""
    err = 0.0
    for lg, rows in zip(logits, entry["logits"]):
        for row, want in zip(np.asarray(lg, np.float32), rows):
            got = row if want["index"] is None else row[want["index"]]
            err = max(err, float(np.abs(
                got - np.asarray(want["value"], np.float32)).max()))
    same = (np.asarray(tokens).tolist() == entry["tokens"]
            and len(logits) == len(entry["logits"]))
    return {"tokens_equal": same, "max_abs_err": err, "tol": LOGITS_TOL,
            "share_of_tol": err / LOGITS_TOL,
            "ok": same and err <= LOGITS_TOL}


def load() -> Dict:
    return json.loads(FIXTURE.read_text())
