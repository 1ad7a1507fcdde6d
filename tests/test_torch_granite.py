"""granite-4.0-h-small in the port (``configs/granite_4_0_h_small.py``, the
``hybrid_moe`` family of ``models/``) against the plain float32 reference
of the benchmark (``cimbench/ref_accel/granite.py``), at small widths on
seeded random weights; and the accelerator-mode backend's recorded step
(``dse/backends.py``): seeded weights, the published-width path, and the
ten reduced archs' graphs unchanged.

The reference package has no such model, so nothing here imports JAX.
"""
import dataclasses
import hashlib
import json
import pathlib

import pytest
import torch

from cimbench.accel_port import program_config
from cimbench.kinds import accel
from cimbench.ref_accel import granite as ref
from repro_torch.configs import granite_4_0_h_small as granite_cfg
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import (ARCHS, PUBLISHED, get_config,
                                          reduced_config)
from repro_torch.dse import DSEEngine, SweepSpace, TpuBackend, TpuOption
from repro_torch.dse import backends
from repro_torch.models import moe, ssm
from repro_torch.models.transformer import _init_leaf
from repro_torch.train import steps

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG_FILE = ROOT / "cimbench" / "configs" / "granite-4.0-h-small-ep8.json"
GRAPHS = (ROOT / "src" / "repro_torch" / "dse" / "fixtures"
          / "reduced_tpu_graphs.json")
#: float32 port against float32 reference: products summed in another
#: order, nothing else
RTOL = 2e-4


def small_file(**over):
    """The benchmark's configuration file cut as its CPU tests cut it, in
    float32, with ``over`` on top."""
    doc = accel.tiny_config(json.loads(CONFIG_FILE.read_text()))
    return dict(doc, **over)


def both(doc):
    return program_config(doc), ref.Spec.of(doc)


def fill(layout, seed):
    gen = torch.Generator().manual_seed(seed)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        return _init_leaf(node, gen, None)
    return go(layout)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def close(a, b, rtol=RTOL):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30)) <= rtol


# ------------------------------------------------------------ the config
def test_config_is_the_published_one_and_the_cut_is_three_keys():
    doc = json.loads(CONFIG_FILE.read_text())
    full, cut = granite_cfg.CONFIG, granite_cfg.EP8
    assert full.layer_types == tuple(doc["layer_types"])
    assert [i for i, t in enumerate(full.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (full.n_layers, full.moe.n_experts, full.vocab_size) == (
        40, 72, 100_352) == tuple(doc["published"][k] for k in doc["reduced"])
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim) == (
        4096, 32, 8, 128)
    assert (full.ssm.n_heads, full.ssm.head_dim, full.ssm.d_state,
            full.ssm.chunk, full.ssm.conv_dim, full.ssm_groups) == (
        128, 64, 128, 256, 4, 1)
    assert (full.moe.top_k, full.moe.expert_d_ff, full.shared_d_ff) == (
        10, 768, 1536)
    assert (full.attention_multiplier, full.embedding_multiplier,
            full.residual_multiplier, full.logits_scaling) == (
        1 / 128, 12, 0.22, 16)
    assert round(full.param_count() / 1e9, 1) == 32.2
    # the cut: layers, experts held, vocabulary; nothing else
    assert program_config(doc) == dataclasses.replace(cut, notes="")
    changed = {f.name for f in dataclasses.fields(full)
               if getattr(full, f.name) != getattr(cut, f.name)}
    assert changed == {"arch_id", "n_layers", "vocab_size", "experts_held"}
    assert cut.pattern == ("mamba",) * 5 + ("attention",) + ("mamba",) * 4
    assert cut.held == tuple(range(9)) and cut.vocab_size == 12_544
    assert round(cut.param_count() / 1e9, 2) == 2.06
    assert get_config(cut.arch_id) is cut and cut.arch_id in PUBLISHED
    assert cut.arch_id not in ARCHS


def test_reduced_config_keeps_both_mixers_and_the_routing():
    r = reduced_config("granite-4.0-h-small-ep8")
    assert r.pattern == ("mamba", "attention") and r.d_model == 64
    assert r.moe.impl == "dropless" and r.logits_scaling == 16


# ------------------------------------------------------------ Mamba-2
@pytest.mark.parametrize("seq_len", [40, 64])
def test_mamba2_mixer_matches_the_reference_ssd_and_recurrence(seq_len):
    cfg, spec = both(small_file())
    p = fill(ssm.mamba2_layout(cfg), 3)
    x = torch.randn(2, seq_len, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    mine = ssm.mamba2_mixer(p, cfg, x)
    num = ref.Numerics()
    chunked = ref.mamba2(p, x, spec, num)
    stepped = ref.mamba2(p, x, spec, num, scan=ref.ssd_recurrence)
    assert close(mine, chunked) and close(chunked, stepped)
    assert float(mine.abs().max()) > 0


def test_ssd_chunked_equals_token_by_token():
    g = torch.Generator().manual_seed(5)
    X = torch.randn(1, 37, 3, 4, generator=g)
    A = -torch.rand(1, 37, 3, generator=g)
    B, C = torch.randn(1, 37, 5, generator=g), torch.randn(1, 37, 5, generator=g)
    assert close(ref.ssd(X, A, B, C, 8, ref.Numerics()),
                 ref.ssd_recurrence(X, A, B, C), 1e-5)


# ------------------------------------------------------------ experts
def _moe_params(cfg, seed):
    return fill(moe.granite_moe_layout(cfg), seed)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Each share holds 4 of 16 experts; the shares' outputs, the shared
    expert counted once, add up to the reference's layer with all 16."""
    cfg, spec = both(small_file(experts_held=list(range(16)),
                                num_local_experts=16))
    p = _moe_params(cfg, 6)
    x = torch.randn(1, 48, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    whole, aux, _, _ = ref.moe(flat(p), x, spec, ref.Numerics())
    total = 0
    for s in range(4):
        held = tuple(range(4 * s, 4 * s + 4))
        part_cfg = dataclasses.replace(cfg, experts_held=held)
        part = dict(p, **{k: p[k][4 * s:4 * s + 4]
                          for k in ("w_gate", "w_up", "w_down")})
        y, a = moe.granite_moe(part, part_cfg, x)
        total = total + y
        assert torch.equal(a, moe.granite_moe(p, cfg, x)[1])
    shared = moe.swiglu(p["shared"], x)
    assert close(total - 3 * shared, whole)
    assert close(a, aux)


def test_dropless_dispatch_keeps_every_token_on_one_expert():
    """A router that sends every token to expert 0: the expert gets all
    of them and the layer equals the reference's."""
    cfg, spec = both(small_file(experts_held=[0, 5]))
    p = _moe_params(cfg, 8)
    p["router"] = p["router"] * 0.01
    p["router"][:, 0] = 1.0
    x = torch.randn(1, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(9)).abs() + 1
    T, k = 64, cfg.moe.top_k
    logits = x.reshape(T, -1) @ p["router"]
    top, idx = moe.top_k(logits, k)
    assert bool((idx[:, 0] == 0).all())
    y, counts = moe.dropless_experts(p, cfg, x.reshape(T, -1), idx,
                                     torch.softmax(top, -1))
    assert counts[0] == T and counts[1] == int((idx == 5).sum())
    mine, _ = moe.granite_moe(p, cfg, x)
    want, _, _, _ = ref.moe(flat(p), x, spec, ref.Numerics())
    assert close(mine, want)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def small_step():
    cfg, spec = both(small_file())
    gen = torch.Generator().manual_seed(11)
    state = steps.init_train_state(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                           dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                           dtype=torch.int32)
    with moe.capture_routing() as routes:
        grads, loss, aux = steps.grads_and_loss(
            state["params"], cfg, {"tokens": tokens, "labels": labels})
    params = {k: v.float() for k, v in flat(state["params"]).items()}
    return cfg, spec, params, tokens.long(), labels.long(), grads, loss, \
        aux, routes


def test_loss_and_gradients_match_the_reference(small_step):
    cfg, spec, params, tokens, labels, grads, loss, aux, routes = small_step
    req = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want_loss, want_aux = ref.forward_loss(req, tokens, labels, spec)
    total = want_loss + ref.AUX_COEF * want_aux
    want = dict(zip(req, torch.autograd.grad(total, list(req.values()))))
    want_loss, want_aux = float(want_loss.detach()), float(want_aux.detach())
    assert abs(float(loss) - want_loss) <= 1e-5 * want_loss
    assert abs(float(aux) - want_aux) <= 1e-5 * want_aux
    mine = flat(grads)
    assert set(mine) == set(want)
    bad = [k for k in want if not close(mine[k], want[k], 1e-3)]
    assert not bad
    assert sorted(routes) == list(range(cfg.n_layers))
    assert all(r.shape == (1, 64, cfg.moe.top_k) for r in routes.values())


def test_layerwise_step_equals_autograd_and_routes_match(small_step):
    """The reference's one-layer-at-a-time gradients equal full autograd;
    its own float32 routing is the port's; AdamW's first moment after one
    step is the clipped gradient times 1 - beta1."""
    cfg, spec, params, tokens, labels, grads, loss, aux, routes = small_step
    idx = {k: torch.arange(min(8, v.numel())) for k, v in params.items()}
    mine_routes = {i: r.reshape(-1, r.shape[-1]) for i, r in routes.items()}
    res = ref.step(params, tokens, labels, spec, idx)
    assert res.route_gap == 0.0
    for i, r in res.routes.items():
        assert torch.equal(r.sort(-1).values,
                           mine_routes[i].sort(-1).values)
    again = ref.step(params, tokens, labels, spec, idx, routes=mine_routes)
    assert again.loss == res.loss
    gn = float(torch.sqrt(sum(g.double().square().sum()
                              for g in flat(grads).values())))
    assert abs(res.grad_norm - gn) <= 1e-4 * gn
    scale = min(1.0, 1.0 / gn)
    for k, m in res.m.items():
        g = flat(grads)[k].reshape(-1)[idx[k]].double()
        assert close(m.double(), 0.1 * g * scale, 1e-3)


def test_train_step_first_moment_is_the_clipped_gradient():
    cfg, _ = both(small_file())
    gen = torch.Generator().manual_seed(12)
    state = steps.init_train_state(gen, cfg)
    batch = {"tokens": torch.randint(0, 512, (1, 32), generator=gen,
                                     dtype=torch.int32),
             "labels": torch.randint(0, 512, (1, 32), generator=gen,
                                     dtype=torch.int32)}
    new, metrics = steps.make_train_step(cfg, TrainConfig())(state, batch)
    grads, _, _ = steps.grads_and_loss(state["params"], cfg, batch)
    scale = min(1.0, 1.0 / float(metrics["grad_norm"]))
    for k, m in flat(new["opt"]["m"]).items():
        assert close(m, 0.1 * flat(grads)[k] * scale, 1e-5)


# ------------------------------------------------------------ TpuBackend
def _small_engine(seed, observed):
    cfg = dataclasses.replace(program_config(small_file(
        dtype="bfloat16")), arch_id="granite-small")
    be = TpuBackend(batch=1, seq_len=32, seed=seed, configs=(cfg,),
                    observe=lambda st, m: observed.append(float(m["loss"])))
    return cfg, DSEEngine(backend=be, device="cpu", max_workers=1)


def test_tpu_backend_records_a_seeded_step_that_routes_by_its_weights():
    observed = []
    cfg, eng = _small_engine(21, observed)
    space = SweepSpace(workloads=("granite-small",),
                       tpus=(TpuOption.of("v5e"), TpuOption.of("v4")))
    with moe.capture_routing() as routes:
        res = eng.run(space)
    assert len(res.records) == 2 and res.stats["trace_builds"] == 1
    assert len(observed) == 1 and observed[0] > 0
    assert sorted(routes) == list(range(cfg.n_layers))
    for r in routes.values():
        ids = r.reshape(-1, cfg.moe.top_k)
        lowest = torch.arange(cfg.moe.top_k)
        # not the all-ties choice of zero weights (the lowest ids)
        assert not bool((ids.sort(-1).values == lowest).all())
        assert len({tuple(t) for t in ids.tolist()}) > 1
    an = eng.backend.analyze(eng.analysis, space.points()[0])
    assert an.workload == "granite-small" and an.flops > 0
    # another seed, another step: the routing and so the graph's shapes
    other, eng2 = _small_engine(22, [])
    with moe.capture_routing() as routes2:
        eng2.run(space)
    assert any(not torch.equal(routes[i], routes2[i]) for i in routes)


def test_published_names_record_at_published_widths():
    for name, cfg in PUBLISHED.items():
        assert backends.model_config(name) is cfg
        assert cfg.d_model == 4096 and cfg.ssm.d_state == 128
        want = hashlib.sha256(f"{name}\n{cfg!r}".encode()).hexdigest()[:16]
        assert backends.arch_fingerprint(name) == want
    mine = dataclasses.replace(granite_cfg.EP8, arch_id="x")
    assert backends.model_config("x", (mine,)) is mine
    assert backends.arch_fingerprint("x", (mine,)) != \
        backends.arch_fingerprint("x")
    for arch in ARCHS:
        assert backends.model_config(arch) == reduced_config(arch)


def _graph_digest(g):
    h = hashlib.sha256()
    for e in g.eqns:
        h.update(repr((e.prim, e.aten, e.invars, e.outvars)).encode())
    h.update(repr((g.shapes, g.itemsizes)).encode())
    return h.hexdigest()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_arch_records_are_unchanged(arch):
    """The step now runs on weights drawn from a seed; the reduced archs'
    shapes do not depend on values, so each graph, its FLOPs, bytes and
    fusion candidates are those recorded on zeros, for any seed."""
    from repro_torch.core.hlo import fusion_candidates
    from repro_torch.core.hlo_cost import analyze_graph
    want = json.loads(GRAPHS.read_text())["archs"][arch]
    for seed in (0, 1234567):
        g = backends.record_train_step(reduced_config(arch), 2, 32, "cpu",
                                       seed=seed)
        rep = fusion_candidates(g)
        rows = [[c.n_ops, c.input_bytes, c.output_bytes, c.saved_bytes]
                for c in rep.candidates]
        assert len(g.eqns) == want["n_eqns"]
        assert analyze_graph(g).flops == want["flops"]
        assert rep.total_bytes == want["total_bytes"]
        assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == \
            want["candidates_sha256"]
        assert _graph_digest(g) == want["graph_sha256"]
