#!/usr/bin/env python3
"""Time the replay kernel against its variants, in turns, on one card.

    python3 probes/replay_variants.py [--rounds N]

All variants run behind ``replay_columns_batch`` (one C interface):

  * ``U=2`` -- ``src/repro_torch/core/accel/csrc/replay.cu``, the kernel
    the port runs: 64 accesses probed at once, two a lane, the hits before
    the first miss resolved together;
  * ``U=1``, ``U=4`` -- the same source with one or four accesses a lane
    (32 or 128 a step), written to ``build/replay_variants/``;
  * ``serial`` -- ``probes/replay_serial.cu``, one access a step with the
    next set loaded ahead.

Each is first held equal to the OrderedDict machine on the astar and KM
streams under the three Fig. 14 geometries and SPM_1M.  Then, per round
(the order reversed every other round), each is timed on the device alone
(``torch.profiler``, the replay kernels and the scratch memsets) on the
astar stream, a stream of one line repeated (every access a first-level
hit) and the empty stream, all under the Fig. 14 geometries, and over the
main path's 17 replays (every fixture's stream, one launch each).  The
whole run goes to ``chiprun_out/replay_variants.json``.
"""
import argparse
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import device_ms_by_kernel, profiled_device_ms  # noqa: E402
from repro_torch.core.accel import _build  # noqa: E402
from repro_torch.core.accel import replay as replay_mod  # noqa: E402
from repro_torch.core.cache import SPM_1M  # noqa: E402
from repro_torch.core.isa import OP_STORE  # noqa: E402
from repro_torch.workloads import fixtures  # noqa: E402


def variant_sources():
    """{name: source path}: the kernel, its step widths, the serial one."""
    text = replay_mod.SRC.read_text()
    width = re.search(r"constexpr int U = (\d+);", text)
    out = {f"U={width.group(1)}": replay_mod.SRC}
    folder = ROOT / "build" / "replay_variants"
    folder.mkdir(parents=True, exist_ok=True)
    for u in (1, 2, 4):
        if f"U={u}" not in out:
            path = folder / f"replay_u{u}.cu"
            path.write_text(text.replace(width.group(0),
                                         f"constexpr int U = {u};"))
            out[f"U={u}"] = path
    out["serial"] = ROOT / "probes" / "replay_serial.cu"
    return dict(sorted(out.items()))


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
    dev = torch.device("cuda", 0)
    variants = variant_sources()
    _build.build(list(variants.values()))
    kernel_src = replay_mod.SRC

    def replay(variant, addrs, wr, geos):
        replay_mod.SRC = variants[variant]
        try:
            return replay_mod.replay_columns_batch(addrs, wr, geos)
        finally:
            replay_mod.SRC = kernel_src

    geos = list(fixtures.CACHES.values())
    streams = {}
    for name in fixtures.WORKLOADS:
        ct = fixtures.load_structural(name, device="cpu").columns
        mem = ct.mem_mask
        streams[name] = (ct.addr[mem].to(dev),
                         (ct.op[mem] == OP_STORE).to(dev))
    for name in ("astar", "KM"):
        a, w = streams[name]
        want = replay_mod.replay_columns_batch(a.cpu(), w.cpu(),
                                               geos + [(SPM_1M,)])
        for variant in variants:
            got = replay(variant, a, w, geos + [(SPM_1M,)])
            for g, r in zip(got, want):
                if g[4] != r[4] or not all(torch.equal(x.cpu(), y)
                                           for x, y in zip(g[:4], r[:4])):
                    print(f"FAIL: {variant} differs from the OrderedDict "
                          f"machine on {name}")
                    sys.exit(1)
    print(f"equal: {len(variants)} variants on astar and KM under "
          f"{len(geos) + 1} geometries", flush=True)

    astar = streams["astar"]
    cases = {"astar": astar,
             "one line": (torch.zeros_like(astar[0]),
                          torch.zeros_like(astar[1])),
             "empty": (astar[0][:0], astar[1][:0])}
    rounds = []
    for r in range(args.rounds):
        order = list(variants) if r % 2 == 0 else list(variants)[::-1]
        rows = {}
        for variant in order:
            row = {}
            for case, (a, w) in cases.items():
                row[case] = profiled_device_ms(
                    lambda: replay(variant, a, w, geos), 5)[0]
            events, _ = device_ms_by_kernel(
                lambda: [replay(variant, a, w, geos)
                         for a, w in streams.values()])
            row["sweep"] = sum(ms for key, (ms, _) in events.items()
                               if "replay_kernel" in key)
            rows[variant] = row
            print(f"round {r} {variant}: device ms " + ", ".join(
                f"{k} {'not measured' if v is None else f'{v:.4f}'}"
                for k, v in row.items()) + " (sweep: the main path's 17 "
                "replays)", flush=True)
        rounds.append(rows)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "replay_variants.json").write_text(json.dumps(
        {"device": smi, "geometries": list(fixtures.CACHES),
         "accesses": astar[0].numel(), "rounds": rounds}, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
