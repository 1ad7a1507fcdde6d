#!/usr/bin/env python3
"""Time the variants of ``probes/bulk_stream.cu`` against ``torch.bitwise_and``.

    python3 probes/bulk_stream.py [--rounds N]

On one CUDA card: builds the probe with the port's ``nvcc`` flags, then for
each variant computes ``x & y`` on two 4096x8192 int32 arrays (the shape
of ``chip_smoke.py``'s bulk ops), checks it equals ``torch.bitwise_and``,
and times it in turns with the library call (variant, library, library,
variant; 50 calls each, CUDA events).  Each round runs every variant; the
table is printed per round with each variant's share of the bytes bound
(two operands read and one result written over 3.35 TB/s), and the whole
run is written to ``chiprun_out/bulk_stream.json``.
"""
import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import bytes_bound_ms, turns_ms  # noqa: E402
from repro_torch.core.accel import _build  # noqa: E402

SHAPE = (4096, 8192)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = _build.load(ROOT / "probes" / "bulk_stream.cu")
    lib.bulk_name.argtypes, lib.bulk_name.restype = (ctypes.c_int,), \
        ctypes.c_char_p
    lib.bulk_run.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_void_p)
    lib.bulk_run.restype = ctypes.c_int
    names = [lib.bulk_name(i).decode() for i in range(lib.bulk_count())]

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    x, y = (torch.randint(-2 ** 31, 2 ** 31 - 1, SHAPE, generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(2))
    want = torch.bitwise_and(x, y)
    out = torch.empty_like(x)
    n4 = x.numel() // 4
    stream = torch.cuda.current_stream(dev).cuda_stream
    bound, _ = bytes_bound_ms(3 * x.numel() * 4, x.numel())

    def run(i):
        _build.check(lib, lib.bulk_run(i, x.data_ptr(), y.data_ptr(),
                                       out.data_ptr(), n4, stream), names[i])

    rounds = []
    for r in range(args.rounds):
        rows = []
        for i, name in enumerate(names):
            out.zero_()
            run(i)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"FAIL: {name} differs from torch.bitwise_and")
                sys.exit(1)
            ms, lib_ms = turns_ms(lambda: run(i),
                                  lambda: torch.bitwise_and(x, y), 50)
            rows.append(dict(name=name, ms=ms, library_ms=lib_ms,
                             ratio=ms / lib_ms, bound_share=bound / ms))
        rounds.append(rows)
        print(f"round {r}: {SHAPE} int32 and, bound {bound:.4f} ms")
        for row in sorted(rows, key=lambda row: row["ms"]):
            print(f"  {row['name']:<20} {row['ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms ({row['ratio']:.3f}x), "
                  f"{row['bound_share']:.3f} of the bound", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bulk_stream.json").write_text(json.dumps(dict(
        shape=SHAPE, bound_ms=bound, card=smi,
        rounds=rounds), indent=1))


if __name__ == "__main__":
    main()
