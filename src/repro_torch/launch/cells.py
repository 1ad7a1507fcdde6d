"""Cell construction: one (arch x shape x mesh) dry-run unit (port of
``repro.launch.cells``).

A *cell* bundles the step function, the shapes and dtypes of its inputs
and the shardings they and its outputs take.  The reference lowers and
compiles it; the port *records* it: :meth:`Cell.record` runs the step once,
eagerly, on DTensors whose local shards are meta tensors (shape and dtype,
no storage), under the cell's rules and a
:class:`~repro_torch.core.hlo.GraphRecorder`, and returns one device's
graph: its local ops and the collectives DTensor issued.

Meta tensors, not ``FakeTensorMode``: DTensor computes the offsets of a
strided shard (a GQA reshape merging a data-sharded and a model-sharded
dim) from a small index tensor it builds and reads back, which
``FakeTensorMode`` refuses as data-dependent; under meta local tensors that
index tensor is an ordinary one.  Either way nothing of the step's size is
allocated.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES, cell_status
from repro_torch.core.hlo import Graph, GraphRecorder
from repro_torch.core.hlo_cost import HloCost, analyze_graph
from repro_torch.dist import sharding as shd
from repro_torch.models import inputs as minputs
from repro_torch.models.inputs import TensorSpec
from repro_torch.models.transformer import param_layout
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.train import steps as steps_mod


@dataclasses.dataclass
class CellRecord:
    """One device's recorded step."""
    graph: Graph
    cost: HloCost
    argument_bytes: int                # this device's shards of the inputs
    output_bytes: int                  # ... and of the outputs
    record_s: float


@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    rules: Dict[str, Any]
    fn: Callable
    in_specs: Tuple[Any, ...]          # TensorSpec trees
    in_shardings: Tuple[Any, ...]      # placement trees
    out_shardings: Any

    @property
    def placement_mesh(self):
        """The mesh the shardings are placements on: the axes the rules
        use (:func:`~repro_torch.dist.sharding.rules_mesh`)."""
        return shd.rules_mesh(self.mesh, self.rules)

    def record(self) -> CellRecord:
        """Run the step once on meta DTensors placed by ``in_shardings``,
        redistribute its outputs to ``out_shardings`` (as a jit's output
        shardings would) and return the per-device graph analysis."""
        pmesh = self.placement_mesh
        args = tuple(materialize(s, sh, pmesh)
                     for s, sh in zip(self.in_specs, self.in_shardings))
        rec = GraphRecorder()
        t0 = time.perf_counter()
        with shd.use_rules(pmesh, self.rules), rec:
            out = tuple(tree_map(lambda t, pl: _place(t, pmesh, pl), o, sh)
                        for o, sh in zip(self.fn(*args), self.out_shardings))
        record_s = time.perf_counter() - t0
        graph = rec.graph()
        return CellRecord(graph, analyze_graph(graph), _local_bytes(args),
                          _local_bytes(out), record_s)

    def record_plain(self) -> Tuple[CellRecord, int]:
        """The same step at world size 1: plain meta tensors, no rules.
        Returns its record and ``FlopCounterMode``'s count of the run, the
        two counts the sharded record is checked against."""
        from torch.utils.flop_counter import FlopCounterMode
        args = tuple(tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                    device="meta"), spec)
                     for spec in self.in_specs)
        rec = GraphRecorder()
        counter = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with counter, rec:
            out = self.fn(*args)
        record_s = time.perf_counter() - t0
        graph = rec.graph()
        return (CellRecord(graph, analyze_graph(graph), _local_bytes(args),
                           _local_bytes(out), record_s),
                counter.get_total_flops())


def _place(t, mesh, pl):
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, shd.placements(mesh, ()),
                               run_check=False)
    return t.redistribute(mesh, pl)


def _local_bytes(trees) -> int:
    """Bytes of this device's shards of every tensor of a tuple of
    trees."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in (leaf for tree in trees for leaf in leaves(tree)):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def materialize(specs, placements_tree, mesh):
    """A tree of :class:`TensorSpec` as meta DTensors on ``mesh``: each
    local shard a meta tensor of the shard's shape."""
    from torch.distributed.tensor import DTensor

    def one(spec: TensorSpec, pl):
        local = list(spec.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= mesh.size(i)
        t = torch.empty(local, dtype=spec.dtype, device="meta")
        full = torch.empty(spec.shape, dtype=spec.dtype, device="meta")
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=full.shape, stride=full.stride())
    return tree_map(one, specs, placements_tree)


def _replicated(mesh, tree):
    return tree_map(lambda _: shd.placements(mesh, ()), tree)


def train_state_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_train_state``'s tree as :class:`TensorSpec` leaves."""
    layout = param_layout(cfg)
    params = tree_map(lambda l: TensorSpec(l.shape, l.torch_dtype), layout)
    moments = tree_map(lambda l: TensorSpec(l.shape, torch.float32), layout)
    return {"params": params, "opt": {"m": moments, "v": moments},
            "step": TensorSpec((), torch.int32)}


def state_shardings(cfg: ModelConfig, mesh, state_shape, zero1: bool = True,
                    strategy: str = "auto"):
    pspecs = shd.param_specs(cfg, mesh, state_shape["params"],
                             strategy=strategy)
    ospecs = (shd.opt_state_specs(cfg, mesh, state_shape["params"], pspecs,
                                  strategy=strategy)
              if zero1 else pspecs)
    out = {
        "params": shd.named(mesh, pspecs),
        "opt": {"m": shd.named(mesh, ospecs), "v": shd.named(mesh, ospecs)},
        "step": shd.placements(mesh, ()),
    }
    if "error_fb" in state_shape:
        out["error_fb"] = shd.named(mesh, ospecs)
    return out


def build_cell(arch: str, shape_name: str, mesh,
               tc: Optional[TrainConfig] = None,
               strategy: str = "auto") -> Cell:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    status = cell_status(cfg, shape)
    if status != "run":
        raise ValueError(f"cell {arch}x{shape_name} is {status}")
    tc = tc or TrainConfig()
    rules = shd.make_rules(cfg, mesh, shape, strategy=strategy)
    return build_cell_for(cfg, shape, mesh, rules, tc=tc, strategy=strategy)


def build_cell_for(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                   tc: Optional[TrainConfig] = None,
                   strategy: str = "auto") -> Cell:
    """:func:`build_cell` for a config and shape not in the registry (the
    reduced configs of the tests).  Shardings are placements on the axes
    the rules use."""
    tc = tc or TrainConfig()
    full_mesh, mesh = mesh, shd.rules_mesh(mesh, rules)

    def batch_shardings(spec):
        return shd.named(mesh, shd.batch_input_shardings(mesh, spec, rules))

    if shape.kind == "train":
        state_shape = train_state_spec(cfg)
        st_sh = state_shardings(cfg, mesh, state_shape, zero1=tc.zero1,
                                strategy=strategy)
        batch_spec = minputs.train_input_specs(cfg, shape)
        fn = steps_mod.make_train_step(cfg, tc)
        metrics_shape = {k: TensorSpec((), torch.float32)
                         for k in ("loss", "aux_loss", "grad_norm", "lr")}
        return Cell(cfg, shape, full_mesh, rules, fn,
                    in_specs=(state_shape, batch_spec),
                    in_shardings=(st_sh, batch_shardings(batch_spec)),
                    out_shardings=(st_sh, _replicated(mesh, metrics_shape)))

    params_shape = train_state_spec(cfg)["params"]
    p_sh = shd.named(mesh, shd.param_specs(cfg, mesh, params_shape,
                                           strategy=strategy))
    b = rules.get("batch")
    tok_sh = shd.placements(mesh, (b,) if b else ())

    if shape.kind == "prefill":
        batch_spec = minputs.prefill_input_specs(cfg, shape)
        fn = steps_mod.make_prefill_step(cfg, cache_len=shape.seq_len)
        cache_shape = minputs.cache_spec(cfg, shape.global_batch,
                                         shape.seq_len)
        cache_sh = shd.named(mesh, shd.cache_specs(cfg, mesh, cache_shape,
                                                   rules))
        return Cell(cfg, shape, full_mesh, rules, fn,
                    in_specs=(params_shape, batch_spec),
                    in_shardings=(p_sh, batch_shardings(batch_spec)),
                    out_shardings=(tok_sh, cache_sh))

    # decode: the new token at the cache's last position (the port's
    # decode step takes its position as a Python int)
    dec = minputs.decode_input_specs(cfg, shape)
    cache_sh = shd.named(mesh, shd.cache_specs(cfg, mesh, dec["cache"],
                                               rules))
    step = steps_mod.make_decode_step(cfg)
    cur_pos = shape.seq_len - 1

    def fn(params, token, cache):
        return step(params, token, cache, cur_pos)
    return Cell(cfg, shape, full_mesh, rules, fn,
                in_specs=(params_shape, dec["token"], dec["cache"]),
                in_shardings=(p_sh, tok_sh, cache_sh),
                out_shardings=(tok_sh, cache_sh))
