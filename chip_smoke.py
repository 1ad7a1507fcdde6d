#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` only (never JAX or the ``repro`` package):

  1. device    -- the card's name and ``nvidia-smi`` name / power limit;
  2. build     -- compiles every ``csrc/*.cu`` and the latency probes of
                  ``probes/latency.cu`` with nvcc, in parallel;
  3. kernels   -- one L2 and one shared-memory round trip, the units of
                  the replay's latency floor; each kernel against its
                  plain version (plain on CPU
                  tensors, kernel on the card, compared with ==): the
                  segment reductions on the astar placement inputs, on
                  random ids with empty and out-of-range segments and on
                  n=0; the replay on the astar stream under the three
                  Fig. 14 geometries and the single-level SPM_1M;
                  then the times of kernel, plain version and the one
                  PyTorch call computing the same function, where one exists,
                  and the replay's time on an empty and on an all-hit stream;
  4. main path -- the 17 trace fixtures priced on the card: one batched
                  replay per workload over the Fig. 14 geometries, Algorithm 1
                  per Fig. 15 CiM level set, pricing per Fig. 16 technology:
                  306 design points, each compared (==) with the reference's
                  reports, with the launch counts of every kernel;
  5. result    -- the kernel table as one JSON line, the nvidia-smi line,
                  and ``{"ok": true, ...}`` as the last line.

Any mismatch, a kernel that the main path never launched, or an exception
ends the run with a non-zero exit code and no ``ok`` line.  Without a CUDA
device it exits with code 2 before doing anything.  Longer output (the
compiler's register report, per-workload stage seconds) goes to
``chiprun_out/chip_smoke.json``.
"""
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
PROBES = ROOT / "probes" / "latency.cu"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, outside the tensor cores


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def event_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` calls (warmed)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps):
    """Mean host milliseconds of ``fn`` (CPU work, no device)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bytes_bound_ms(n_bytes, n_ops):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the (fp32 non-tensor) peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import accel
    from repro_torch.core.accel import _build
    from repro_torch.core.accel import replay as replay_mod
    from repro_torch.core.accel.pallas_ops import segment_max, segment_sum
    from repro_torch.core.accel.place import _flat_arrays
    from repro_torch.core.accel.replay import replay_columns_batch
    from repro_torch.core.cache import SPM_1M
    from repro_torch.core.isa import OP_STORE
    from repro_torch.core.offload import OffloadConfig, select_candidates
    from repro_torch.core.trace import attach_cache_results_batch
    from repro_torch.workloads import fixtures

    dev = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    detail = {}

    # ---------------------------------------------------------- 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    print(smi, flush=True)

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    per_source = _build.build([*_build.sources().values(), PROBES])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(per_source)}", flush=True)
    detail["build_s"] = build_s
    detail["build_logs"] = dict(_build.build_logs)

    # --------------------------------------------------------- 3. kernels
    # round trips of one dependent load: in the card's L2 cache (an 8 MB
    # ring) and in shared memory (a 32 KB ring)
    gen = torch.Generator().manual_seed(0)
    probe = _build.load(PROBES)
    probe.l2_chase.argtypes = (ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_void_p)
    probe.smem_chase.argtypes = (ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_void_p)
    probe.l2_chase.restype = probe.smem_chase.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    sink = torch.empty(1, dtype=torch.int64, device=dev)

    def ring(n_slots, dtype):
        perm = torch.randperm(n_slots, generator=gen)
        nxt = torch.empty(n_slots, dtype=torch.int64)
        nxt[perm] = torch.roll(perm, -1)
        return nxt.to(dtype).to(dev)

    l2_ring, smem_ring, steps = ring(1 << 20, torch.int64), \
        ring(1 << 13, torch.int32), 1 << 16
    l2_ns = event_ms(lambda: _build.check(probe, probe.l2_chase(
        l2_ring.data_ptr(), steps, sink.data_ptr(), stream), "l2_chase"),
        3) * 1e6 / steps
    smem_ns = event_ms(lambda: _build.check(probe, probe.smem_chase(
        smem_ring.data_ptr(), smem_ring.numel(), steps, sink.data_ptr(),
        stream), "smem_chase"), 3) * 1e6 / steps
    print(f"round trip: L2 {l2_ns:.1f} ns, shared memory {smem_ns:.2f} ns",
          flush=True)

    kernels = {}
    astar = fixtures.load_structural("astar", device=dev)
    ct = astar.columns
    mem_idx = torch.nonzero(ct.mem_mask).flatten()
    addrs = ct.addr[mem_idx]
    is_w = ct.op[mem_idx] == OP_STORE
    geos = list(fixtures.CACHES.values())
    print(f"replay stream: astar, {addrs.numel()} accesses", flush=True)

    # replay: kernel vs the OrderedDict machine, three depth-2 geometries in
    # one launch plus SPM_1M (depth 1) in another
    got = replay_columns_batch(addrs, is_w, geos + [(SPM_1M,)])
    torch.cuda.synchronize()
    ref = replay_columns_batch(addrs.cpu(), is_w.cpu(), geos + [(SPM_1M,)])
    replay_err = 0
    for gi, (g, r) in enumerate(zip(got, ref)):
        for name, a, b in zip(("level", "hit", "bank", "mshr"), g[:4], r[:4]):
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                fail(f"replay geometry {gi} column {name} differs")
            replay_err = max(replay_err, int(
                (a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max()))
        if g[4] != r[4]:
            fail(f"replay geometry {gi} counters {g[4]} != {r[4]}")
    n_acc = addrs.numel()
    ms = event_ms(lambda: replay_columns_batch(addrs, is_w, geos), 5)
    addrs_cpu, is_w_cpu = addrs.cpu(), is_w.cpu()
    plain = host_ms(lambda: replay_columns_batch(addrs_cpu, is_w_cpu, geos),
                    1)
    out_bytes = sum(c.element_size() for c in got[0][:4])
    rb, rb_by = bytes_bound_ms(
        n_acc * (addrs.element_size() + is_w.element_size())
        + len(geos) * n_acc * out_bytes, 0)
    # latency floor: the geometries run side by side, one block each; in
    # each, every access probes the first level (shared memory when the
    # wrapper keeps it there, else the card's L2) and every first-level
    # miss probes the second level, in the card's L2
    l1_smem = (max(g[0].n_sets * g[0].assoc for g in geos)
               * replay_mod._WAY_BYTES <= replay_mod._SMEM_BYTES)
    floor = {}
    for (key, g), r in zip(fixtures.CACHES.items(), got):
        l1_misses = r[4][f"{g[0].name}_misses"]
        floor[key] = (n_acc * (smem_ns if l1_smem else l2_ns)
                      + l1_misses * l2_ns) * 1e-6
    lat_ms = max(floor.values())
    # fixed cost (state clearing, launch, wrapper) and the hit path alone
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    empty_ms = event_ms(lambda: replay_columns_batch(
        empty, empty.to(torch.bool), geos), 5)
    one_line = torch.zeros_like(addrs)
    reads = torch.zeros_like(is_w)
    hit_ms = event_ms(lambda: replay_columns_batch(one_line, reads, geos), 5)
    hit_ns = (hit_ms - empty_ms) * 1e6 / n_acc
    kernels["replay"] = dict(
        twin="src/repro/core/accel/replay.py::replay_columns_batch",
        source="src/repro_torch/core/accel/csrc/replay.cu",
        replaces="src/repro/core/accel/replay.py:202",
        equal=True, max_abs_err=replay_err, ms=ms, plain_ms=plain,
        bound_ms=rb, bound_by=rb_by, library_ms=None,
        shape=f"{n_acc} accesses x {len(geos)} geometries (one launch)",
        latency_bound_ms=lat_ms, latency_bound_per_geometry_ms=floor,
        l2_round_trip_ns=l2_ns, smem_round_trip_ns=smem_ns,
        empty_stream_ms=empty_ms, all_hit_ns_per_access=hit_ns)
    print(f"replay: equal on {len(geos) + 1} geometries; {ms:.3f} ms "
          f"kernel, {plain:.1f} ms plain (host); latency floor "
          f"{lat_ms:.3f} ms; empty stream {empty_ms:.3f} ms; all-hit "
          f"stream {hit_ns:.1f} ns per access", flush=True)

    # segment reductions at the main path's largest shape: astar's
    # placement under 32K+256K / both
    tr = attach_cache_results_batch(astar, [geos[0]], device=dev)[0]
    cfg = OffloadConfig(cim_levels=("L1", "L2"))
    select_candidates(tr.trace, cfg, device=dev)   # memoizes the partition
    part = tr.trace._struct["partitions"][cfg.partition_key()]
    leaf_seq, leaf_pid, acc_seq, acc_pid, _ = _flat_arrays(part, tr.trace,
                                                           cfg)
    n_seg = len(part.protos)
    depth = torch.clamp(tr.trace.level[leaf_seq].to(torch.int32) - 1, max=1)
    n_rand = 4096
    rand_ids = torch.randint(-3, 70, (n_rand,), generator=gen,
                             dtype=torch.int32)
    rand_vals = torch.randint(-1000, 1000, (n_rand,), generator=gen,
                              dtype=torch.int32)
    cases = [("astar placement", depth, leaf_pid, n_seg),
             ("random, empty and out-of-range segments", rand_vals.to(dev),
              rand_ids.to(dev), 64),
             ("n=0", torch.zeros(0, dtype=torch.int32, device=dev),
              torch.zeros(0, dtype=torch.int32, device=dev), 5)]
    for name, op, lib_call in (
            ("segment_sum", segment_sum,
             lambda v, i, s: torch.zeros(s, dtype=torch.int32,
                                         device=v.device).index_add_(
                 0, i.to(torch.int64), v)),
            ("segment_max", segment_max,
             lambda v, i, s: torch.full((s,), -2 ** 31, dtype=torch.int32,
                                        device=v.device).scatter_reduce_(
                 0, i.to(torch.int64), v, "amax"))):
        err = 0
        for case, v, i, s in cases:
            a = op(v, i, s)
            torch.cuda.synchronize()
            b = op(v.cpu(), i.cpu(), s)
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                fail(f"{name} differs from its plain version on {case}")
            if a.numel():
                err = max(err, int((a.cpu().to(torch.int64)
                                    - b.to(torch.int64)).abs().max()))
        v, i = depth, leaf_pid
        v_cpu, i_cpu = v.cpu(), i.cpu()
        ms = event_ms(lambda: op(v, i, n_seg), 50)
        plain = host_ms(lambda: op(v_cpu, i_cpu, n_seg), 20)
        i64 = i.to(torch.int64)
        lib_ms = event_ms(lambda: lib_call(v, i64, n_seg), 50)
        n = v.numel()
        bound, by = bytes_bound_ms(n * 8 + n_seg * 4, n)
        twin_line = 88 if name == "segment_sum" else 96
        kernels[name] = dict(
            twin=f"src/repro/core/accel/pallas_ops.py::{name}",
            source="src/repro_torch/core/accel/csrc/segment_reduce.cu",
            replaces=f"src/repro/core/accel/pallas_ops.py:{twin_line}",
            equal=True, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=lib_ms,
            shape=f"n={n}, n_segments={n_seg}")
        print(f"{name}: equal on {len(cases)} cases; {ms:.4f} ms kernel, "
              f"{lib_ms:.4f} ms library, {plain:.3f} ms plain (host)",
              flush=True)

    # ------------------------------------------------------- 4. main path
    golden = fixtures.reference_reports()["workloads"]
    stage = {}
    per_workload = {}
    n_rec = n_equal = 0
    mismatches = []
    accel.reset_launch_counts()
    t0 = time.perf_counter()
    for name in fixtures.WORKLOADS:
        w0 = time.perf_counter()
        st = fixtures.load_structural(name, device=dev)
        records, counters = fixtures.price_design_points(
            st, device=dev, stage_seconds=stage)
        ref = golden[name]
        n_rec += len(records)
        for a, b in zip(records, ref["records"]):
            if a == b:
                n_equal += 1
            else:
                mismatches.append((name, a, b))
        if len(records) != len(ref["records"]):
            mismatches.append((name, "record count", len(records)))
        if counters != ref["counters"]:
            mismatches.append((name, "counters", counters))
        per_workload[name] = time.perf_counter() - w0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = accel.launch_counts()
    print(f"main path: {n_rec} records, {n_equal} equal, "
          f"{n_rec - n_equal} mismatched; {wall:.2f} s wall", flush=True)
    print("stage seconds: " + json.dumps(
        {k: round(v, 3) for k, v in stage.items()}), flush=True)
    print("launches: " + json.dumps(launches), flush=True)
    detail.update(stage_seconds=stage, workload_seconds=per_workload,
                  main_path_wall_s=wall, launches=launches,
                  mismatches=[repr(m) for m in mismatches[:50]],
                  kernels=kernels)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if mismatches or n_rec != 306 or n_equal != n_rec:
        for m in mismatches[:10]:
            print("MISMATCH", m)
        fail(f"{len(mismatches)} mismatches against the reference reports")
    for name in accel.KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")

    # ---------------------------------------------------------- 5. result
    table = []
    for name in accel.KERNELS:
        k = kernels[name]
        table.append({"name": name, "route": "cuda", "source": k["source"],
                      "replaces": k["replaces"], "twin": k["twin"],
                      "launches": launches[name], "equal": k["equal"],
                      "tolerance": 0, "max_abs_err": k["max_abs_err"],
                      "ms": k["ms"],
                      "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                      "bound_by": k["bound_by"],
                      "library_ms": k["library_ms"], "shape": k["shape"],
                      **{x: k[x] for x in (
                          "latency_bound_ms", "latency_bound_per_geometry_ms",
                          "l2_round_trip_ns", "smem_round_trip_ns",
                          "empty_stream_ms", "all_hit_ns_per_access")
                         if x in k}})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
