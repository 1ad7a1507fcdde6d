#!/usr/bin/env python3
"""Time the f32 attention kernel against its variants, in turns, on one card.

    python3 probes/flash_f32_variants.py [--rounds N] [--only NAME ...]

All variants share the C entry ``flash_attention`` of
``src/repro_torch/kernels/csrc/flash_attention.cu`` and run on gemma3-1b's
attention at B=1, S=4096 in f32 (H=4, Hkv=1, d=256), the shapes of
``chip_smoke.py`` phase 5:

  * ``port``       -- the kernel the port runs (3xTF32 ``mma.sync``);
  * ``port-no-qk``, ``port-no-pv``, ``port-no-loads`` -- the port's source
    with one part taken out (the Q.K^T products, the P.V products, the K/V
    loads after the first tile), written to ``build/flash_variants/``, so
    that the differences show what each part costs (their results are
    wrong, and not checked);
  * ``simt``       -- ``probes/flash_f32_simt.cu``, the scalar-FMA kernel it
    replaced; ``simt-no-qk``, ``simt-no-pv``, ``simt-no-loads`` the same
    with one part taken out (see that file).

Each full variant (not a ``-no-`` one) is first held to the plain version
(``repro_torch.kernels.ref``) within atol 2e-5, rtol 2e-5 on gemma3-1b
layer 0 (window 512) and on a ragged small shape.  Then, per round (the
order reversed every other round), each is timed in CUDA events on a
global and a window-512 layer, 10 calls each, and the full variants on a
whole prefill's 26 layers.  The whole run goes to
``chiprun_out/flash_f32_variants.json``.
"""
import argparse
import json
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (FLASH_TOL, GEMMA, allclose_err, event_ms,  # noqa: E402
                        layer_windows, ptxas_summary)
from repro_torch.core.accel import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SIMT = ROOT / "probes" / "flash_f32_simt.cu"
SIMT_PARTS = {"simt-no-qk": "SKIP_QK", "simt-no-pv": "SKIP_PV",
              "simt-no-loads": "SKIP_LOADS"}
#: the port's source with one part taken out: (text, replacement) pairs,
#: each found exactly once
PORT_PARTS = {
    "port-no-qk": [("        mma_3xtf32(s[j], a, x.x, x.y);",
                    "        (void)x;")],
    "port-no-pv": [(
        "        mma_3xtf32(acc[n], a, Vs[v_at<D>(kr, col + 8 * n)],\n"
        "                   Vs[v_at<D>(kr + 1, col + 8 * n)]);",
        "        (void)a;")],
    "port-no-loads": [
        ("    load_tile_f32<D, true>(Vs,",
         "    if (kt == lo) load_tile_f32<D, true>(Vs,"),
        ("    if (kt + 1 < hi)\n      load_tile_f32<D, false>(Ks,",
         "    if (false)\n      load_tile_f32<D, false>(Ks,")],
}


def variant_sources():
    """{name: source path} of ``port``, ``simt`` and their parts."""
    folder = ROOT / "build" / "flash_variants"
    folder.mkdir(parents=True, exist_ok=True)
    out = {"port": fa._SRC, "simt": SIMT}
    for name, flag in SIMT_PARTS.items():
        path = folder / f"{name}.cu"
        path.write_text(f"#define {flag} 1\n" + SIMT.read_text())
        out[name] = path
    text = fa._SRC.read_text()
    for name, edits in PORT_PARTS.items():
        part = text
        for old, new in edits:
            if part.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} not found once in "
                                 f"{fa._SRC}")
            part = part.replace(old, new)
        path = folder / f"{name}.cu"
        path.write_text(part)
        out[name] = path
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", nargs="*", help="the variants to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    variants = variant_sources()
    if args.only:
        variants = {k: v for k, v in variants.items() if k in args.only}
    _build.build(list(variants.values()))
    ptxas = {}
    for name, path in variants.items():
        ptxas[name] = [row for row in ptxas_summary(
            _build.build_logs.get(path.stem, "")) if "wgmma" not in row]

    def run(name, q, k, v, window):
        lib, fn = _build.function(variants[name], "flash_attention",
                                  fa._SIG)
        B, H, Sq, d = q.shape
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                H, k.shape[1], Sq, k.shape[2], d, 1, window,
                1.0 / math.sqrt(d), 0,
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, f"{name} launch")
        return out

    g = GEMMA
    windows = layer_windows(g)
    gen = torch.Generator(device=dev).manual_seed(5)
    layers = [tuple(torch.randn(g["batch"], h, g["seq"], g["head_dim"],
                                generator=gen, device=dev)
                    for h in (g["heads"], g["kv_heads"], g["kv_heads"]))
              for _ in windows]
    cpu_gen = torch.Generator().manual_seed(6)
    small = (torch.randn(1, 4, 136, 64, generator=cpu_gen),
             *(torch.randn(1, 1, 136, 64, generator=cpu_gen)
               for _ in range(2)))
    full = [n for n in variants if "-no-" not in n]
    checks = {}
    want_l0 = ref.flash_attention_ref(*(t.cpu() for t in layers[0]),
                                      window=windows[0])
    want_small = ref.flash_attention_ref(*small, window=48)
    for name in full:
        e0 = allclose_err(run(name, *layers[0], windows[0]), want_l0,
                          FLASH_TOL[torch.float32])
        e1 = allclose_err(run(name, *(t.to(dev) for t in small), 48),
                          want_small, FLASH_TOL[torch.float32])
        torch.cuda.synchronize()
        checks[name] = dict(layer0=e0, ragged_d64=e1)
        print(f"{name}: max_abs_err {e0[0]:.3g} ({e0[1]:.3f} of the "
              f"tolerance) on layer 0, {e1[0]:.3g} ({e1[1]:.3f}) on "
              f"(1, 4, 1, 136, 64) window 48; ptxas {ptxas[name]}",
              flush=True)
        if not (e0[1] <= 1 and e1[1] <= 1):
            raise SystemExit(f"{name} differs from the plain version")

    first_global = windows.index(0)
    times = {n: {"global": [], "window": [], "prefill": []} for n in variants}
    for rnd in range(args.rounds):
        order = list(variants) if rnd % 2 == 0 else list(variants)[::-1]
        for name in order:
            for kind, li in (("global", first_global), ("window", 0)):
                times[name][kind].append(event_ms(
                    lambda: run(name, *layers[li], windows[li]), 10))
            if name in full:
                times[name]["prefill"].append(event_ms(
                    lambda: [run(name, *x, w)
                             for x, w in zip(layers, windows)], 2))
    summary = {}
    for name, t in times.items():
        summary[name] = {k: sum(v) / len(v) for k, v in t.items() if v}
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in summary[name].items()),
              flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_f32_variants.json").write_text(json.dumps(dict(
        device=smi, rounds=args.rounds, summary=summary, times=times,
        checks=checks, ptxas=ptxas,
        sources={k: str(v.relative_to(ROOT)) for k, v in variants.items()}),
        indent=1))


if __name__ == "__main__":
    main()
