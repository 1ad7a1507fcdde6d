"""The accel kind's traffic and system under test
(:mod:`cimbench.kinds.accel`): cold accelerator-mode analyses of a model's
train step by the port's ``DSEEngine`` with its ``TpuBackend``, each on
weights drawn from a seed of its own, and what each left behind.

It takes from ``repro_torch`` the engine, the backend, the configuration
classes and the model's routing capture, and nothing of its arithmetic;
the spans and launch counters every kind reads come through
:mod:`cimbench.program`.
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from cimbench.ref_accel.flops import step_flops
from cimbench.ref_accel.granite import Spec, layout


def load(path) -> Dict:
    with open(path) as f:
        return json.load(f)


def program_config(config: Dict):
    """The program's configuration of a configuration file (catalog
    keys): every width as the file gives it, the router over the
    published experts, the held experts and the vocabulary slice."""
    from repro_torch.configs.base import (HybridMoEConfig, MoEConfig,
                                          SSMConfig)
    c = config
    return HybridMoEConfig(
        arch_id=c["name"], family="hybrid_moe",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"], d_ff=0,
        vocab_size=c["vocab_size"], rope_theta=float(c["rope_theta"]),
        norm_eps=c["rms_norm_eps"], tie_embeddings=c["tie_word_embeddings"],
        moe=MoEConfig(n_experts=c["published"]["num_local_experts"],
                      top_k=c["num_experts_per_tok"],
                      expert_d_ff=c["intermediate_size"],
                      n_shared_experts=1, capacity_factor=0.0,
                      impl="dropless"),
        ssm=SSMConfig(kind="mamba2", d_state=c["mamba_d_state"],
                      n_heads=c["mamba_n_heads"], head_dim=c["mamba_d_head"],
                      chunk=c["mamba_chunk_size"], conv_dim=c["mamba_d_conv"]),
        layer_types=tuple(c["layer_types"]),
        experts_held=tuple(c["experts_held"]),
        shared_d_ff=c["shared_intermediate_size"],
        ssm_groups=c["mamba_n_groups"],
        attention_multiplier=float(c["attention_multiplier"]),
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        logits_scaling=float(c["logits_scaling"]),
        param_dtype=c["dtype"], compute_dtype=c["dtype"], source=c["source"])


class Traffic:
    """A mix's units: each one cold analysis of the configuration at
    ``batch`` x ``seq_len`` on weights drawn from a seed of its own (drawn
    from the run's seed), priced at every (chip, threshold) of the mix."""

    def __init__(self, params: Dict, config: Dict, seed: int):
        self.params = params
        self.seed = seed
        self.batch, self.seq_len = params["batch"], params["seq_len"]
        self.points = [{"chip": c, "threshold": t}
                       for c in params["chips"] for t in params["thresholds"]]
        self._draw = np.random.default_rng([seed, 0])
        self.warm_seed = self.unit_seed()

    def unit_seed(self) -> int:
        return int(self._draw.integers(0, 1 << 62))

    def units(self):
        while True:
            yield {"points": list(self.points), "seed": self.unit_seed()}


def leaf(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


class Port:
    """One run's analyses on ``device``."""

    def __init__(self, traffic: Traffic, config: Dict, device: str):
        self.traffic = traffic
        self.device = device
        self.cfg = program_config(config)
        self.spec = Spec.of(config)
        per_leaf = traffic.params["sample_per_leaf"]
        draw = np.random.default_rng([traffic.seed, 1])
        self.sample_idx = {
            path: draw.integers(0, int(np.prod(shape)), per_leaf)
            for path, shape, _, _ in layout(self.spec)}
        self._idx = {p: torch.as_tensor(i, device=device)
                     for p, i in self.sample_idx.items()}

    # ------------------------------------------------------------ a unit
    def _backend(self, seed: int, kept: Dict):
        from repro_torch.dse import TpuBackend

        def observe(new_state, metrics):
            m = new_state["opt"]["m"]
            flat = torch.cat([leaf(m, p).reshape(-1)[i]
                              for p, i in self._idx.items()]).cpu().numpy()
            kept["m"] = dict(zip(self._idx, np.split(flat, np.cumsum(
                [len(i) for i in self._idx.values()])[:-1])))
            kept["loss"] = float(metrics["loss"])
            kept["grad_norm"] = float(metrics["grad_norm"])
        return TpuBackend(batch=self.traffic.batch,
                          seq_len=self.traffic.seq_len, seed=seed,
                          configs=(self.cfg,), observe=observe)

    def _points(self):
        from repro_torch.dse import SweepSpace, TpuOption, parse_bytes
        return SweepSpace(workloads=(self.cfg.arch_id,), tpus=tuple(
            TpuOption(TpuOption.of(p["chip"]).chip,
                      parse_bytes(p["threshold"]))
            for p in self.traffic.points)).points()

    def analyse(self, seed: int) -> Dict:
        """One cold analysis; returns the records, the analysis numbers
        and what the step left (loss, gradient norm, the sampled first
        moments, each layer's choice of experts)."""
        from repro_torch.dse import DSEEngine
        from repro_torch.models.moe import capture_routing
        kept: Dict = {}
        eng = DSEEngine(backend=self._backend(seed, kept),
                        device=self.device, max_workers=1)
        points = self._points()
        with capture_routing() as routes:
            res = eng.run(points)
            layers = sorted(routes)
            stacked = torch.stack([routes[i].reshape(-1, routes[i].shape[-1])
                                   for i in layers]).cpu().numpy()
        builds = eng.analysis.stats()["trace_builds"]
        an = eng.backend.analyze(eng.analysis, points[0])
        if eng.analysis.stats()["trace_builds"] != builds:
            raise RuntimeError("the engine did not hold its analysis")
        held = np.asarray(self.cfg.held)
        return dict(
            kept, records=[r.to_dict() for r in res.records],
            analysis={"flops": an.flops, "total_bytes": an.total_bytes,
                      "collective_bytes": an.collective_bytes,
                      "n_eqns": an.n_eqns,
                      "candidates": np.asarray(
                          [(c.n_ops, c.input_bytes, c.output_bytes,
                            c.saved_bytes) for c in an.candidates],
                          np.int64).reshape(-1, 4)},
            routes=dict(zip(layers, stacked)),
            held_rows=[int(np.isin(r, held).sum()) for r in stacked],
            seed=seed)

    def warm(self) -> int:
        self.analyse(self.traffic.warm_seed)
        return len(self.traffic.points)

    def run_unit(self, unit: Dict) -> Dict:
        return self.analyse(unit["seed"])

    @staticmethod
    def release(unit: Dict) -> None:
        """Drop what only the check of a held unit reads."""
        unit["out"]["m"] = unit["out"]["routes"] = None

    def read_back(self, units: List[Dict]) -> None:
        return None

    def traced_fields(self, units: List[Dict], spans, ref) -> Dict:
        """``step_flops``: each unit's matrix-product FLOPs as the
        benchmark counts them from the widths and its routing."""
        t = self.traffic
        return {"step_flops": [step_flops(self.spec, t.batch, t.seq_len,
                                          u["out"]["held_rows"])
                               for u in units]}

    def sample(self, units: List[Dict], ref, seed: int) -> Dict:
        """Every unit's records and analysis; the held units' step
        outputs with the sampled indices."""
        return {"batch": self.traffic.batch, "seq_len": self.traffic.seq_len,
                "points": self.traffic.points, "idx": self.sample_idx,
                "units": [u["out"] for u in units]}
