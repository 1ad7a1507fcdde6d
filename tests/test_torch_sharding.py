"""repro_torch.dist.sharding against repro.dist.sharding.

The rule tables and spec trees of all ten archs at published widths, on the
(16, 16) and (2, 16, 16) production meshes, are ``==`` the reference's (its
specs computed live on ``jax.sharding.AbstractMesh`` over ``jax.eval_shape``
trees, the port's on :class:`repro_torch.dist.sharding.AbstractMesh` over
``param_layout`` and meta-device caches) and the committed fixture the card
reads.  ``shard()``'s spec per call is the reference's rule on synthetic
shapes.  ``python tests/test_torch_sharding.py --regenerate`` rewrites the
fixture (refusing when the port disagrees).
"""
import sys

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs.registry import ARCHS, get_config
from repro.configs.shapes import ALL_SHAPES
from repro.dist import sharding as ref
from repro.models import inputs as ref_inputs
from repro.models.transformer import init_params

from repro_torch.dist import fixtures
from repro_torch.dist import sharding as port


def _is_spec(s):
    return isinstance(s, PartitionSpec)


def _path(kp) -> str:
    return "/".join(str(k.key) for k in kp)


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)
    return {_path(kp): list(s) for kp, s in flat}


def _inputs(tree, shardings):
    shapes = {_path(kp): l for kp, l in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda s: isinstance(s, jax.sharding.Sharding))
    return {_path(kp): [list(shapes[_path(kp)].shape),
                        jnp.dtype(shapes[_path(kp)].dtype).name,
                        list(getattr(s, "spec", s))]
            for kp, s in flat}


def reference_record(arch, mesh_kind):
    cfg = get_config(arch)
    mesh = AbstractMesh(*fixtures.MESHES[mesh_kind])
    rules = ref.make_rules(cfg, mesh)
    params = jax.eval_shape(lambda r: init_params(r, cfg),
                            jax.random.PRNGKey(0))
    pspecs = ref.param_specs(cfg, mesh, params)
    rec = {"rules": rules,
           "param_shapes": {_path(kp): list(l.shape) for kp, l in
                            jax.tree_util.tree_flatten_with_path(params)[0]},
           "params": _flat(pspecs),
           "opt": _flat(ref.opt_state_specs(cfg, mesh, params, pspecs)),
           "inputs": {}, "cache": {}}
    for shape in ALL_SHAPES:
        if shape.kind == "train":
            spec = ref_inputs.train_input_specs(cfg, shape)
        elif shape.kind == "prefill":
            spec = ref_inputs.prefill_input_specs(cfg, shape)
        else:
            dec = ref_inputs.decode_input_specs(cfg, shape)
            rec["cache"][shape.name] = _inputs(
                dec["cache"], ref.cache_specs(cfg, mesh, dec["cache"], rules))
            spec = {"token": dec["token"]}
        rec["inputs"][shape.name] = _inputs(
            spec, _specs_of(ref.batch_input_shardings(mesh, spec, rules)))
    return rec


def _specs_of(named_tree):
    return jax.tree_util.tree_map(
        lambda s: s.spec, named_tree,
        is_leaf=lambda s: isinstance(s, jax.sharding.Sharding))


@pytest.mark.parametrize("mesh_kind", sorted(fixtures.MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference_and_fixture(arch, mesh_kind):
    want = reference_record(arch, mesh_kind)
    got = fixtures.port_record(arch, mesh_kind)
    assert sorted(got) == sorted(want)
    for part in want:
        assert got[part] == want[part], part
    assert fixtures.load()[mesh_kind][arch] == want


@pytest.mark.parametrize("strategy", ["auto", "data", "dp", "sp", "2d"])
@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((1, 1), ("data", "model")),
                                        ((8, 1), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_make_rules_equal_reference(shape, axes, strategy):
    cfg = get_config("qwen1.5-0.5b")
    assert port.make_rules(cfg, port.AbstractMesh(shape, axes),
                           strategy=strategy) == \
        ref.make_rules(cfg, AbstractMesh(shape, axes), strategy=strategy)


_SHARD_CASES = [
    ((8, 16, 4, 32), ("batch", "seq", "heads", None)),
    ((3, 16, 4, 32), ("batch", "seq", "heads", None)),   # batch not dividing
    ((8, 16, 6, 32), ("batch", "seq", "heads", None)),   # heads not dividing
    ((8, 16, 64), ("batch", "seq", "embed")),
    ((8, 16, 64), ("batch", "seq", "embed_out")),
    ((8, 16, 100), ("batch", "seq", "vocab")),
    ((8, 16, 96), ("batch", "seq", "dff")),
    ((8, 4, 16, 64), ("batch", "expert", "cap", "embed")),
    ((8, 8, 8), ("heads", "dff", "vocab")),              # repeated axis
    ((8, 8, 8), ("batch", "batch", None)),               # repeated axis
    ((8, 8), ("unknown", None)),
    ((8,), (None,)),
]


@pytest.mark.parametrize("strategy", ["auto", "data"])
@pytest.mark.parametrize("shape,names", _SHARD_CASES)
def test_shard_spec_equals_reference_rule(shape, names, strategy):
    """The spec ``shard()`` redistributes to is the one the reference's
    ``shard`` constrains to (its ``with_sharding_constraint`` is mocked to
    hand back the spec), on a (2, 4) mesh."""
    cfg = get_config("qwen1.5-0.5b")
    pmesh = port.AbstractMesh((2, 4), ("data", "model"))
    rmesh = AbstractMesh((2, 4), ("data", "model"))
    got = port.activation_spec(pmesh, port.make_rules(cfg, pmesh,
                                                      strategy=strategy),
                               shape, names)
    seen = []

    def constrain(x, sharding):
        seen.append(tuple(sharding.spec))
        return x
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = constrain
    try:
        with ref.use_rules(rmesh, ref.make_rules(cfg, rmesh,
                                                 strategy=strategy)):
            ref.shard(x, *names)
    finally:
        jax.lax.with_sharding_constraint = orig
    assert got == (seen[0] if seen else ())


def test_shard_is_identity_without_rules_and_checks_rank():
    x = torch.ones(2, 3)
    assert port.shard(x, "batch", "seq") is x
    mesh = port.AbstractMesh((2, 4), ("data", "model"))
    rules = port.make_rules(get_config("qwen1.5-0.5b"), mesh)
    with pytest.raises(ValueError, match="axis names"):
        port.activation_spec(mesh, rules, (2, 3), ("batch",))
    rmesh = AbstractMesh((2, 4), ("data", "model"))
    with ref.use_rules(rmesh, ref.make_rules(get_config("qwen1.5-0.5b"),
                                             rmesh)):
        with pytest.raises(ValueError, match="axis names"):
            ref.shard(jnp.ones((2, 3)), "batch")


def test_shard_refuses_a_plain_tensor_under_rules():
    """Under active rules a plain tensor that the rules would shard is an
    error; one they leave whole passes (both without a process group)."""
    mesh = port.AbstractMesh((2, 4), ("data", "model"))
    rules = port.make_rules(get_config("qwen1.5-0.5b"), mesh)
    with port.use_rules(mesh, rules):
        with pytest.raises(TypeError, match="plain tensor"):
            port.shard(torch.ones(8, 4), "batch", None)
        x = torch.ones(3, 4)
        assert port.shard(x, "batch", None) is x
    x = torch.ones(8, 4)                     # the rules are gone again
    assert port.shard(x, "batch", None) is x


def regenerate():
    want = {mk: {a: reference_record(a, mk) for a in sorted(ARCHS)}
            for mk in sorted(fixtures.MESHES)}
    bad = fixtures.mismatches(fixtures.port_records(), want)
    if bad:
        raise SystemExit(f"the port disagrees with the reference: {bad}")
    import json
    fixtures.PATH.write_text(json.dumps(want, indent=0, sort_keys=True) + "\n")
    print(f"wrote {fixtures.PATH}")


if __name__ == "__main__":
    if "--regenerate" in sys.argv:
        regenerate()
