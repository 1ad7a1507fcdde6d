#!/usr/bin/env python3
"""Time the serve and train drivers' steps, parent against change, on one
card.

    python3 probes/driver_steps.py --parent DIR [--first change] [--out FILE]

For this checkout and a checkout of the parent commit (``DIR``, unpacked
with ``git archive <commit> | tar -x -C DIR``), timed in turns (parent,
change, change, parent), each run a fresh Python process on the card:

  * ``serve`` -- ``python -m repro_torch.launch.serve --arch gemma3-1b
    --preset full --batch 4 --gen 32`` with prompts of 64 and 1024
    tokens (bf16, the config's dtype): prefill seconds and milliseconds a
    decode step;
  * ``train`` -- ``python -m repro_torch.launch.train --arch gemma3-1b
    --preset full --batch 4 --seq-len 1024 --steps 8 --remat block
    --save-every 0``: each step's milliseconds and their median from the
    second step on (the final snapshot goes to a temporary directory that
    is deleted).

The serve runs take six turns (parent, change, change, parent, parent,
change; ``--first change`` swaps the two names), the train runs the first
four.  Both drivers run unsharded
(``--model-parallel 1``), the path every single-card user takes.  Once
per tree, ``ops`` counts the ATen ops one full-width decode step (B=4,
prompt 64) and one prefill dispatch on the card: the same count means the
same device work, whatever the host's clock reads.  ``group`` times, in
one process of this checkout, blocks of five full-width decode steps
with no process group and with the world-1 ``nccl`` group the drivers
make (``launch.mesh.ensure_group``), in turns.  It prints one line per
run and a summary, and writes everything to
``chiprun_out/driver_steps.json``.
"""
import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

SERVE = ["-m", "repro_torch.launch.serve", "--arch", "gemma3-1b",
         "--preset", "full", "--batch", "4", "--gen", "32"]
TRAIN = ["-m", "repro_torch.launch.train", "--arch", "gemma3-1b",
         "--preset", "full", "--batch", "4", "--seq-len", "1024",
         "--steps", "8", "--remat", "block", "--save-every", "0",
         "--log-every", "100"]


_OPS = """
import json, torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs.registry import get_config
from repro_torch.models import inputs as minputs
from repro_torch.models.transformer import init_params
from repro_torch.train import steps as steps_mod


class Count(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        Count.n += 1
        return func(*args, **(kwargs or {}))


cfg = get_config("gemma3-1b")
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
with torch.inference_mode():
    params = init_params(gen, cfg, device=dev)
    batch = minputs.make_train_batch(gen, cfg, 4, 64, device=dev)
    batch.pop("labels")
    prefill = steps_mod.make_prefill_step(cfg, cache_len=96)
    decode = steps_mod.make_decode_step(cfg)
    with Count():
        tok, cache = prefill(params, batch)
    out["prefill_ops"], Count.n = Count.n, 0
    with Count():
        decode(params, tok, cache, 64)
    out["decode_ops"] = Count.n
print(json.dumps(out))
"""


_GROUP = """
import json, statistics, time, torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import ensure_group
from repro_torch.models import inputs as minputs
from repro_torch.models.transformer import init_params
from repro_torch.train import steps as steps_mod

cfg = get_config("gemma3-1b")
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
times = {"no_group": [], "nccl_group": []}
with torch.inference_mode():
    params = init_params(gen, cfg, device=dev)
    batch = minputs.make_train_batch(gen, cfg, 4, 64, device=dev)
    batch.pop("labels")
    decode = steps_mod.make_decode_step(cfg)
    tok, cache = steps_mod.make_prefill_step(cfg, cache_len=400)(params,
                                                                 batch)
    pos = 64

    def block():
        global tok, cache, pos
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            tok, cache = decode(params, tok, cache, pos)
            pos += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 5 * 1e3

    block(), block()
    for _ in range(8):
        times["no_group"] += [block() for _ in range(4)]
        ensure_group("cuda")
        times["nccl_group"] += [block() for _ in range(4)]
        dist.destroy_process_group()
print(json.dumps({k: {"median_ms": statistics.median(v), "min_ms": min(v),
                      "blocks_ms": v} for k, v in times.items()}))
"""


def _json_line(text: str) -> dict:
    for line in reversed(text.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise ValueError(f"no JSON line in {text[-2000:]!r}")


def _run(tree: pathlib.Path, argv, timeout: int) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree / "src")}
    proc = subprocess.run([sys.executable, *argv], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree.name}: {' '.join(argv[:2])} exit "
                           f"{proc.returncode}: {proc.stderr[-3000:]}")
    return _json_line(proc.stdout)


def measure(tree: pathlib.Path, train: bool) -> dict:
    out = {}
    for prompt in (64, 1024):
        doc = _run(tree, [*SERVE, "--prompt-len", str(prompt)], 600)
        out[f"serve_{prompt}"] = {
            "prefill_ms": doc["prefill_s"] * 1e3,
            "decode_ms_per_step": doc["decode_s"] * 1e3 / doc["decode_steps"],
            "tokens_per_s": doc["tokens_per_s"]}
    if not train:
        return out
    ckpt = pathlib.Path(tempfile.mkdtemp(prefix="driver_steps_"))
    try:
        doc = _run(tree, [*TRAIN, "--ckpt-dir", str(ckpt)], 900)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["train"] = {"step_ms": doc["step_ms"],
                    "median_step_ms": doc["median_step_ms"],
                    "final_loss": doc["final_metrics"]["loss"],
                    "peak_memory_bytes": doc["peak_memory_bytes"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--first", default="parent", choices=["parent", "change"])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "driver_steps.json"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": pathlib.Path(args.parent).resolve(), "change": ROOT}
    ops = {name: _run(tree, ["-c", _OPS], 600)
           for name, tree in trees.items()}
    print(json.dumps({"ops": ops}), flush=True)
    group = _run(ROOT, ["-c", _GROUP], 900)
    print(json.dumps({"group": group}), flush=True)
    a, b = ("parent", "change")[::1 if args.first == "parent" else -1]
    runs = []
    for i, name in enumerate((a, b, b, a, a, b)):
        got = measure(trees[name], train=i < 4)
        runs.append({"tree": name, **got})
        print(json.dumps(runs[-1]), flush=True)
    summary = {"ops": ops, "order": [r["tree"] for r in runs],
               "group": {k: v["median_ms"] for k, v in group.items()}}
    for name in ("parent", "change"):
        mine = [r for r in runs if r["tree"] == name]
        trained = [r for r in mine if "train" in r]
        summary[name] = {
            "decode_ms_per_step_64": [r["serve_64"]["decode_ms_per_step"]
                                      for r in mine],
            "decode_ms_per_step_1024": [r["serve_1024"]["decode_ms_per_step"]
                                        for r in mine],
            "prefill_ms_1024": [r["serve_1024"]["prefill_ms"] for r in mine],
            "train_median_step_ms": [r["train"]["median_step_ms"]
                                     for r in trained],
            "train_final_loss": [r["train"]["final_loss"] for r in trained]}
    print(json.dumps({"summary": summary}), flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"device": smi, "runs": runs, "ops": ops,
                                "group": group, "summary": summary},
                               indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
