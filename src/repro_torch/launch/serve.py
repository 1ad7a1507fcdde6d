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
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.core.columnar import resolve_device
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
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise SystemExit(
            f"--model-parallel {args.model_parallel}: the sharded serving "
            "path waits for the port of dist/ (dist/sharding.py, "
            "launch/mesh.py); this driver runs on one device only")
    dev = resolve_device(args.device)

    cfg = (reduced_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    max_len = args.prompt_len + args.gen
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = init_params(gen, cfg, device=dev)
        batch = minputs.make_train_batch(gen, cfg, args.batch,
                                         args.prompt_len, device=dev)
        batch.pop("labels")
        prefill = steps_mod.make_prefill_step(cfg, cache_len=max_len)
        decode = steps_mod.make_decode_step(cfg)

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

    gen_tokens = torch.cat(outs, dim=1).cpu().numpy()
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(json.dumps({"device": name, "prefill_s": t_prefill,
                      "decode_s": t_decode, "decode_steps": args.gen - 1,
                      "tokens_per_s": tps}), flush=True)
    print(f"[serve] arch={args.arch} batch={args.batch} "
          f"prefill={t_prefill*1e3:.1f}ms "
          f"decode={t_decode*1e3:.1f}ms ({tps:.1f} tok/s)", flush=True)
    print(f"[serve] sample tokens: {gen_tokens[0][:16]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
