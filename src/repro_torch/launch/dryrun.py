"""Multi-pod dry run: record every (arch x shape x mesh) cell per device
(port of ``repro.launch.dryrun``).

One fake process group (``torch.testing._internal.distributed.fake_pg``:
collectives return at once and move nothing) of world size 256, or 512 for
``--mesh both``, stands in for the reference's forced host-device count;
the (16, 16) and (2, 16, 16) production meshes are built over its ranks
without touching a device.  Each cell's step runs once on meta DTensors
(:meth:`repro_torch.launch.cells.Cell.record`), so published widths
allocate nothing.  One JSON artifact per cell goes to
``build/dryrun_torch/<mesh>/`` (``DRYRUN_DIR`` overrides it) with the keys
``repro_torch.core.roofline.cell_roofline`` reads:

* ``flops_per_device`` / ``bytes_accessed_per_device`` — the recorded
  graph's matmul FLOPs and non-view tensor bytes
  (:func:`~repro_torch.core.hlo_cost.analyze_graph`); the ``*_scaled_*``
  twins are equal, since an eager graph has no loop body counted once;
* ``collectives`` — the local output bytes of each collective DTensor
  issued, by HLO opcode, with ``<kind>_count`` and ``total``;
* ``memory`` — this device's shards of the arguments and outputs;
  ``temp_bytes`` is ``null``: the recorder keeps no tensor alive and meta
  tensors use no allocator, so there is no live-bytes peak to read;
* ``record_s`` (for the reference's ``lower_s`` / ``compile_s``) and
  ``eqns``, the recorded graph's op count; ``while_trip_counts`` is ``[]``;
* ``kernel_launches`` — the launches of each hand-written kernel while
  the cell was recorded (and checked).

Resumable: existing artifacts are skipped unless ``--force``.  A failing
cell is written with ``ok: false`` and its error, and the sweep goes on;
``main`` returns 1 if any cell failed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
      --arch yi-34b --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time
import traceback

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import ALL_SHAPES, cell_status
from repro_torch.launch import kernel_launches, reset_kernel_launches

ART = pathlib.Path(os.environ.get(
    "DRYRUN_DIR",
    pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"))

WORLD = {"single": 256, "multi": 512, "both": 512}


def init_fake_group(world_size: int) -> None:
    """The process-wide fake group the production meshes are built over
    (a no-op when one of at least ``world_size`` ranks exists)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks "
                               f"exists; the dry run needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def record_json(rec_in: dict, cell_rec, n_devices: int) -> dict:
    """The artifact of one recorded cell."""
    cost = cell_rec.cost
    coll = {k: int(v) for k, v in cost.collectives.items()}
    coll["total"] = int(cost.collective_total)
    rec = dict(rec_in)
    rec.update(
        ok=True,
        record_s=round(cell_rec.record_s, 2),
        eqns=len(cell_rec.graph.eqns),
        flops_per_device=cost.flops,
        bytes_accessed_per_device=cost.bytes,
        memory={"argument_bytes": cell_rec.argument_bytes,
                "output_bytes": cell_rec.output_bytes,
                "temp_bytes": None, "alias_bytes": None},
        collectives=coll,
        flops_scaled_per_device=cost.flops,
        bytes_scaled_per_device=cost.bytes,
        collectives_scaled={k: v for k, v in cost.collectives.items()},
        collective_scaled_total=cost.collective_total,
        while_trip_counts=[],
        n_devices=n_devices,
    )
    return rec


def flop_checks(build, auto_flops: float) -> dict:
    """The per-device FLOP checks of one cell.  ``build(strategy)`` makes
    the cell; the step is recorded at world size 1 (plain meta tensors)
    and under ``strategy="data"``:

    * the world-1 count equals ``FlopCounterMode``'s;
    * under "data" each device does exactly the world-1 count / the data
      split (the model axis replicates);
    * under "auto" each device does between the world-1 count / the
      device count and / the data split.

    The data split is the data axis's size, or 1 where the global batch
    does not divide it (``long_500k``'s single sequence stays whole).
    """
    from repro_torch.dist.sharding import mesh_axes
    data_cell = build("data")
    world1, counted = data_cell.record_plain()
    data = data_cell.record()
    n = data_cell.mesh.size()
    dsize = mesh_axes(data_cell.mesh).get("data", 1)
    if data_cell.shape.global_batch % dsize:
        dsize = 1
    w1 = world1.cost.flops
    return {
        "world1_flops": w1, "flop_counter": counted,
        "data_flops_per_device": data.cost.flops, "data_size": dsize,
        "n_devices": n, "auto_flops_per_device": auto_flops,
        "world1_equals_counter": w1 == counted,
        "data_is_world1_over_data": data.cost.flops * dsize == w1,
        "auto_within_bounds": w1 / n <= auto_flops <= w1 / dsize,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, force: bool = False,
             strategy: str = "auto", tc=None, device: str = "cuda",
             out_dir=None, check: bool = False) -> dict:
    """Record one cell (or read its artifact back); with ``check`` the
    artifact also holds :func:`flop_checks` under ``flop_checks``, and a
    failed check fails the cell."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    outdir = pathlib.Path(out_dir or ART) / mesh_kind
    outdir.mkdir(parents=True, exist_ok=True)
    suffix = "" if strategy == "auto" and tc is None else f"__{strategy}"
    path = outdir / f"{arch}__{shape_name}{suffix}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())

    cfg = get_config(arch)
    shape = [s for s in ALL_SHAPES if s.name == shape_name][0]
    status = cell_status(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": status,
        "strategy": strategy,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if status != "run":
        path.write_text(json.dumps(rec, indent=1))
        return rec

    t0 = time.time()
    reset_kernel_launches()
    try:
        init_fake_group(WORLD[mesh_kind])
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device=device)
        cell = build_cell(arch, shape_name, mesh, tc=tc, strategy=strategy)
        rec = record_json(rec, cell.record(), mesh.size())
        if check:
            checks = flop_checks(
                lambda s: build_cell(arch, shape_name, mesh, tc=tc,
                                     strategy=s),
                rec["flops_per_device"])
            rec["flop_checks"] = checks
            failed = [k for k, v in checks.items() if v is False]
            if failed:
                raise AssertionError(f"per-device FLOP checks failed: "
                                     f"{failed} ({checks})")
        rec["kernel_launches"] = kernel_launches()
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
              f"(record {rec['record_s']}s, {rec['eqns']} eqns, "
              f"flops/dev {rec['flops_per_device']:.3e}, "
              f"collective bytes/dev {rec['collectives']['total']:.3e})",
              flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   tb=traceback.format_exc()[-4000:],
                   record_s=round(time.time() - t0, 2))
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: FAIL "
              f"{type(e).__name__}: {e}", flush=True)
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="default: all 10")
    ap.add_argument("--shape", default=None, help="default: all shapes")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--strategy", default="auto", choices=["auto", "dp", "sp"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device type of the meshes (no device is touched)")
    ap.add_argument("--out", default=None,
                    help=f"artifact directory (default {ART})")
    ap.add_argument("--check", action="store_true",
                    help="also record each cell at world size 1 and under "
                         "strategy 'data', and check the per-device FLOPs")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    init_fake_group(WORLD[args.mesh])

    n_ok = n_fail = n_skip = 0
    for mk in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mk, force=args.force,
                               strategy=args.strategy, device=args.device,
                               out_dir=args.out, check=args.check)
                if rec["status"] != "run":
                    n_skip += 1
                elif rec.get("ok"):
                    n_ok += 1
                else:
                    n_fail += 1
    print(f"[dryrun] done: ok={n_ok} fail={n_fail} skip={n_skip}", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
