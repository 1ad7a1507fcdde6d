"""Batched serving driver on the card: prefill a batch of prompts, then
decode greedily (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --preset full --batch 4 --prompt-len 64 --gen 32

Runs on ``--device cuda`` (the default; no card is an error, never a
fallback) or, when asked, ``--device cpu``.  Weights and prompts are
random, drawn on the device from seed 0.  One untimed prefill and decode
step come first, so the printed times are steady-state ones (the
reference's include its jit compile).  The KV cache is updated in place
under ``torch.inference_mode()``.

``--model-parallel k`` runs the reference's sharded flow: the host mesh
(``launch.mesh.make_host_mesh``: (ranks / k, k) when k divides the ranks,
else (ranks, 1)), its rules, and the steps under ``use_rules``.  Under
``torchrun`` every rank draws the same weights and prompts from the seed
and keeps its shard (parameters by ``param_specs``, prompts by
``batch_input_shardings``); rank 0 prints.  On one process the mesh is
(1, 1), every spec replicates, and the run is the unsharded one: plain
tensors, no rules entered.  The JSON line also holds the launches of each
hand-written kernel over the run (``kernel_launches``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.core.columnar import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.launch import kernel_launches, reset_kernel_launches
from repro_torch.launch.mesh import make_host_mesh, owned_group
from repro_torch.models import inputs as minputs
from repro_torch.models.transformer import init_params
from repro_torch.train import steps as steps_mod


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=sorted(ARCHS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="parameter and compute dtype (default: the "
                         "config's)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with owned_group(dev):
        return _serve(args, dev)


def _serve(args, dev) -> int:
    import torch.distributed as dist
    cfg = (reduced_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                                  compute_dtype=args.dtype)
    mesh = make_host_mesh(args.model_parallel, device=dev.type)
    rules = shd.make_rules(cfg, mesh)
    lead = dist.get_rank() == 0
    reset_kernel_launches()
    max_len = args.prompt_len + args.gen
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = init_params(gen, cfg, device=dev)
        batch = minputs.make_train_batch(gen, cfg, args.batch,
                                         args.prompt_len, device=dev)
        batch.pop("labels")
        prefill = steps_mod.make_prefill_step(cfg, cache_len=max_len)
        decode = steps_mod.make_decode_step(cfg)
        if any(rules.values()):
            pmesh = shd.rules_mesh(mesh, rules)
            params = shd.distribute(params, pmesh, shd.named(
                pmesh, shd.param_specs(cfg, pmesh, params)))
            batch = shd.distribute(batch, pmesh, shd.named(
                pmesh, shd.batch_input_shardings(pmesh, batch, rules)))
            prefill = shd.with_rules(pmesh, rules, prefill)
            decode = shd.with_rules(pmesh, rules, decode)

        tok, cache = prefill(params, batch)              # warm-up
        decode(params, tok, cache, args.prompt_len)
        _sync(dev)

        t0 = time.perf_counter()
        tok, cache = prefill(params, batch)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        outs = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            tok, cache = decode(params, tok, cache, args.prompt_len + i)
            outs.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    gen_tokens = shd.gather({"t": torch.cat(outs, dim=1)})["t"].cpu().numpy()
    if not lead:
        return 0
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(json.dumps({"device": name, "prefill_s": t_prefill,
                      "decode_s": t_decode, "decode_steps": args.gen - 1,
                      "tokens_per_s": tps, "mesh": shd.mesh_axes(mesh),
                      "kernel_launches": kernel_launches(),
                      "tokens": gen_tokens.tolist()}), flush=True)
    print(f"[serve] arch={args.arch} batch={args.batch} "
          f"prefill={t_prefill*1e3:.1f}ms "
          f"decode={t_decode*1e3:.1f}ms ({tps:.1f} tok/s)", flush=True)
    print(f"[serve] sample tokens: {gen_tokens[0][:16]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
