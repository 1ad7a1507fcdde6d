"""The sharding rules and spec trees of every arch at its published widths,
as one JSON record per (arch, mesh), and the reference's records committed
beside them (``reference_specs.json``).

A record holds the rule table, the parameter and ZeRO-1 optimizer specs
(keyed by ``/``-joined tree path), each shape's input specs (shape, dtype
name and spec of every leaf) and the decode shapes' cache specs.  The port's
side is built from ``param_layout`` and meta-device caches, so nothing is
allocated; the card compares it with the committed file, since the card's
machine may have no jax.  Regenerate the file (needs jax; refuses to write
when the port disagrees) with
``PYTHONPATH=src python tests/test_torch_sharding.py --regenerate``.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import ALL_SHAPES
from repro_torch.dist import sharding as shd
from repro_torch.models import inputs as minputs
from repro_torch.models.transformer import param_layout
from repro_torch.optim.tree import leaves_with_path

PATH = pathlib.Path(__file__).resolve().parent / "reference_specs.json"

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree) -> Dict[str, Any]:
    return {p: list(s) for p, s in leaves_with_path(tree)}


def _inputs(tree, specs) -> Dict[str, Any]:
    shapes = dict(leaves_with_path(tree))
    return {p: [list(shapes[p].shape), shapes[p].dtype_name, list(s)]
            for p, s in leaves_with_path(specs)}


def port_record(arch: str, mesh_kind: str) -> Dict[str, Any]:
    """The port's rules and specs of ``arch`` on the named abstract mesh."""
    cfg = get_config(arch)
    mesh = shd.AbstractMesh(*MESHES[mesh_kind])
    rules = shd.make_rules(cfg, mesh)
    layout = param_layout(cfg)
    pspecs = shd.param_specs(cfg, mesh, layout)
    rec = {"rules": rules,
           "param_shapes": {p: list(l.shape)
                            for p, l in leaves_with_path(layout)},
           "params": _flat(pspecs),
           "opt": _flat(shd.opt_state_specs(cfg, mesh, layout, pspecs)),
           "inputs": {}, "cache": {}}
    for shape in ALL_SHAPES:
        if shape.kind == "train":
            spec = minputs.train_input_specs(cfg, shape)
        elif shape.kind == "prefill":
            spec = minputs.prefill_input_specs(cfg, shape)
        else:
            dec = minputs.decode_input_specs(cfg, shape)
            rec["cache"][shape.name] = _inputs(
                dec["cache"], shd.cache_specs(cfg, mesh, dec["cache"], rules))
            spec = {"token": dec["token"]}
        rec["inputs"][shape.name] = _inputs(
            spec, shd.batch_input_shardings(mesh, spec, rules))
    return rec


def port_records() -> Dict[str, Any]:
    return {mk: {a: port_record(a, mk) for a in ARCHS} for mk in MESHES}


def load() -> Dict[str, Any]:
    return json.loads(PATH.read_text())


def mismatches(got: Dict[str, Any], want: Dict[str, Any]):
    """``(mesh, arch, part)`` of every record part that differs."""
    out = []
    for mk in sorted(set(got) | set(want)):
        g, w = got.get(mk, {}), want.get(mk, {})
        for arch in sorted(set(g) | set(w)):
            a, b = g.get(arch, {}), w.get(arch, {})
            out.extend((mk, arch, part) for part in sorted(set(a) | set(b))
                       if a.get(part) != b.get(part))
    return out
