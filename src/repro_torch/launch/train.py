"""End-to-end training driver on the card (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --preset smoke --steps 100 --ckpt-dir /tmp/ckpt

``--preset smoke`` trains the family-preserving reduced config; ``--preset
full`` uses the assigned architecture verbatim.  The loop runs under the
fault-tolerance manager: auto-resume, async atomic checkpoints, straggler
monitoring; ``--fail-at N`` injects a failure at step N to demonstrate
recovery.  Runs on ``--device cuda`` (the default; no card is an error,
never a fallback) or, when asked, ``--device cpu``.  Weights are random,
drawn on the device from seed 0; batches come from the seeded synthetic
stream of ``repro_torch.data``.

``--model-parallel k`` runs the reference's sharded flow: the host mesh
(``launch.mesh.make_host_mesh``), its rules, and each step under
``use_rules``.  Under ``torchrun`` every rank draws the same state from
the seed and keeps its shard of it (parameters by ``param_specs``, moments
by the ZeRO-1 ``opt_state_specs``), builds the same global batch from the
stream and keeps its rows; rank 0 prints and writes the checkpoints, from
the full tensors, and a resume re-places them
(``ckpt.checkpoint.ShardedCheckpointManager``).  On one process the mesh
is (1, 1), every spec replicates, and the run is the unsharded one: plain
tensors, no rules entered.

Besides the reference's ``[train]`` lines it prints one JSON line: the
device, each step's milliseconds (the step and a sync; the first includes
the warm-up), their median from the second step on, tokens/s at that
median, the device's peak allocated bytes, the step's FLOPs
(:func:`train_flops`), the final snapshot's bytes and seconds, the last
metrics, and the launches of each hand-written kernel over the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import time

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.core.columnar import resolve_device
from repro_torch.ckpt.checkpoint import ShardedCheckpointManager, latest_step
from repro_torch.data.pipeline import DataConfig, ShardedTokenPipeline
from repro_torch.dist import sharding as shd
from repro_torch.ft.manager import FaultTolerantRunner
from repro_torch.launch import kernel_launches, reset_kernel_launches
from repro_torch.launch.cells import state_shardings
from repro_torch.launch.mesh import make_host_mesh, owned_group
from repro_torch.models.inputs import _text_len
from repro_torch.models.transformer import layer_windows
from repro_torch.train import steps as steps_mod


def _live_pairs(sq: int, skv: int, window: int, causal: bool = True) -> int:
    """(query, key) pairs a causal (and windowed, if > 0) mask keeps."""
    if not causal:
        return sq * skv
    return sum(min(q + 1, skv, window) if window > 0 else min(q + 1, skv)
               for q in range(sq))


def train_flops(cfg: ModelConfig, batch: int, seq_len: int) -> int:
    """One step's FLOPs: 6 x active parameters x tokens, plus the attention
    scores the masks keep -- per live (query, key) pair and head, 2 x
    head_dim for Q.K^T and as many for P.V in the forward, twice that in the
    backward (12 x head_dim in all).  Masked scores the code computes
    anyway are not counted."""
    tokens = batch * seq_len
    per_pair = 12 * cfg.head_dim * cfg.n_heads * batch
    pairs = 0
    if cfg.family != "ssm":
        pairs = sum(_live_pairs(seq_len, seq_len, int(w))
                    for w in layer_windows(cfg))
    if cfg.family == "encdec":
        se = max(1, seq_len // cfg.enc_len_ratio)
        pairs = (cfg.n_layers * _live_pairs(seq_len, seq_len, 0)
                 + cfg.n_enc_layers * se * se + cfg.n_layers * seq_len * se)
    return 6 * cfg.active_param_count() * tokens + per_pair * pairs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "block", "full"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="parameter and compute dtype (default: the "
                         "config's)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with owned_group(dev):
        return _train(args, dev)


def _train(args, dev) -> int:
    import torch.distributed as dist
    cfg = (reduced_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                                  compute_dtype=args.dtype)
    tc = TrainConfig(total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                     microbatches=args.microbatches, remat=args.remat,
                     grad_compression=args.grad_compression)
    mesh = make_host_mesh(args.model_parallel, device=dev.type)
    rules = shd.make_rules(cfg, mesh)
    pmesh = shd.rules_mesh(mesh, rules)
    lead = dist.get_rank() == 0
    sharded = any(rules.values())
    reset_kernel_launches()
    if lead:
        print(f"[train] arch={args.arch} preset={args.preset} "
              f"params={cfg.param_count()/1e6:.1f}M "
              f"mesh={shd.mesh_axes(mesh)}", flush=True)

    data = ShardedTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch))

    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_train_state(gen, cfg, device=dev)
    if sharded:
        st_sh = state_shardings(cfg, pmesh, state, zero1=tc.zero1)
        state = shd.distribute(state, pmesh, st_sh)
    step_fn = steps_mod.make_train_step(cfg, tc)
    step_ms, losses = [], []
    last_end = [time.perf_counter()]

    def run_step(state, batch):
        t0 = time.perf_counter()
        if sharded:
            with shd.use_rules(pmesh, rules):
                state, metrics = step_fn(state, batch)
                # the new state as the old one is placed
                state = shd.distribute(state, pmesh, st_sh)
            metrics = shd.gather(metrics)
        else:
            state, metrics = step_fn(state, batch)
        _sync(dev)
        last_end[0] = time.perf_counter()
        step_ms.append((last_end[0] - t0) * 1e3)
        losses.append(metrics["loss"])
        return state, metrics

    def batch_at(step: int):
        b = data.batch_at(step)
        out = {"tokens": torch.from_numpy(b["tokens"]).to(dev),
               "labels": torch.from_numpy(b["labels"]).to(dev)}
        if cfg.family == "encdec":
            Se = max(1, args.seq_len // cfg.enc_len_ratio)
            out["enc_embeds"] = torch.zeros((args.batch, Se, cfg.d_model),
                                            dtype=torch.bfloat16, device=dev)
        if cfg.family == "vlm" and cfg.n_prefix_embeds_ratio:
            St = _text_len(cfg, args.seq_len)
            out["tokens"] = out["tokens"][:, :St]
            out["prefix_embeds"] = torch.zeros(
                (args.batch, args.seq_len - St, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if sharded:
            out = shd.distribute(out, pmesh, shd.named(
                pmesh, shd.batch_input_shardings(pmesh, out, rules)))
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ckpt = (ShardedCheckpointManager(args.ckpt_dir, pmesh,
                                     every=args.save_every)
            if sharded else None)
    runner = FaultTolerantRunner(args.ckpt_dir, save_every=args.save_every,
                                 ckpt=ckpt)
    t0 = time.perf_counter()
    state, report = runner.run(state, args.steps, run_step, batch_at,
                               log_every=args.log_every if lead else 0,
                               fail_at=args.fail_at)
    t_end = time.perf_counter()
    dt = t_end - t0
    if not lead:
        return 0
    final = latest_step(args.ckpt_dir)
    ckpt = pathlib.Path(args.ckpt_dir) / f"{final}.npz"
    median = statistics.median(step_ms[1:] or step_ms) if step_ms else None
    flops = train_flops(cfg, args.batch, args.seq_len)
    print(json.dumps({
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "arch": args.arch, "preset": args.preset, "batch": args.batch,
        "seq_len": args.seq_len, "remat": args.remat,
        "losses": [float(loss) for loss in losses],
        "param_count": cfg.param_count(), "step_ms": step_ms,
        "median_step_ms": median,
        "tokens_per_s": (args.batch * args.seq_len / (median / 1e3)
                         if median else None),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "flops_per_step": flops, "mesh": shd.mesh_axes(mesh),
        "kernel_launches": kernel_launches(),
        "ckpt_step": final, "ckpt_bytes": ckpt.stat().st_size,
        "ckpt_s": t_end - last_end[0],
        "final_metrics": report.final_metrics}), flush=True)
    print(f"[train] done in {dt:.1f}s: steps={report.steps_run} "
          f"resumed_from={report.resumed_from} "
          f"recoveries={report.failures_recovered} "
          f"final={report.final_metrics} straggler={report.straggler}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
