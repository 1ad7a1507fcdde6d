#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` only (never JAX or the ``repro`` package):

  1. device    -- the card's name and ``nvidia-smi`` name / power limit;
  2. build     -- compiles every ``csrc/*.cu`` of ``repro_torch.core.accel``
                  and of ``repro_torch.kernels`` and the latency probes of
                  ``probes/latency.cu`` with nvcc, in parallel, and prints
                  the registers, stack frames and spills of the attention,
                  segment, replay and mLSTM kernels;
  3. kernels   -- one L2 and one shared-memory round trip, the units of
                  the replay's latency floor; each kernel against its
                  plain version (plain on CPU
                  tensors, kernel on the card, compared with ==): the
                  segment reductions on the astar placement inputs, on
                  random ids with empty and out-of-range segments and on
                  n=0; the replay on the astar stream under the three
                  Fig. 14 geometries and the single-level SPM_1M;
                  placement on the astar placement (also against
                  ``place_sorted``, its formulation from the segment
                  kernels and a sort) and on synthetic partitions with
                  runs of up to 1,100 accesses under the three level sets;
                  then the times of kernel, plain version and the one
                  PyTorch call computing the same function, where one exists
                  (kernel and library timed in turns: kernel, library,
                  library, kernel), the segment reductions' and placement's
                  device-only time and kernels per call from
                  ``torch.profiler``, where a placement call's time goes
                  (device, call to lists, the join) for the kernel and for
                  ``place_sorted``, and the replay's time on an empty and
                  on an all-hit stream, in CUDA events and on the device
                  alone (``torch.profiler``), its ns per access on the
                  all-hit and astar streams, and its latency floors;
  3b. trace frontend -- each of the 17 Table-IV workloads built
                  (``repro_torch.workloads.build``) and run on the port's
                  trace VM (``trace_structural``, a dispatch-mode
                  interpreter on the host, columns on the card): every
                  array of its columns compared (==) with the committed
                  reference trace, integer outputs ==, float outputs within
                  1e-4; per workload its instruction count and seconds,
                  then the total;
  4. main path -- the 306 design points of the Fig. 14 geometries x
                  Fig. 15 CiM level sets x Fig. 16 technologies through
                  ``DSEEngine.run`` on the card, as a user sweeps them: the
                  17 programs traced on the VM, one batched replay per
                  workload, Algorithm 1 per (geometry, level set) with one
                  placement launch each, pricing per technology; each
                  record compared (==) with the reference's reports by
                  (cache, level set, tech), the replay counters too; the
                  launch counts of every kernel, equal to the engine's
                  builds; the stage seconds from the engine's spans
                  (``obs.stage_attribution``, self time per stage, one
                  pricing thread so they add up to the wall); then the same
                  sweep again on a fresh engine under ``torch.profiler``:
                  each kernel's summed device time and the device's busy
                  share;
  5. kernels path: a prefill's launches at published widths -- the CiM
                  modules of ``repro_torch.kernels`` through ``ops`` only:
                  the 26 attention layers of a gemma3-1b prefill (B=1,
                  S=4096; 22 windowed, 4 global) in f32 and again in bf16,
                  the 6 mLSTM blocks of an xlstm-125m prefill (B=8,
                  S=2048), every bulk op and the fused add/xor on
                  4096x8192 int32 and uint32 arrays; counted, then each
                  kernel held against its plain version (the oracle of
                  ``repro_torch.kernels.ref``, on CPU copies) at these
                  widths, at the shapes of tests/test_kernels.py and, for
                  mLSTM in bf16, at xlstm-125m's width on a short sequence;
                  then timed beside its plain version, its bound (the bulk
                  ops with their share of it) and, where one exists, a
                  PyTorch library call; f32 attention and the mLSTM against
                  their 3xTF32 bound and the same flops in f32 outside the
                  tensor cores, the mLSTM also beside its one-SM-per-chain
                  floor, with its four kernels' device time; the share of
                  the tolerance of f32 and bf16 attention;
  6. DSE and artifacts -- the paper artifacts through the port's runner
                  (``repro_torch.bench``: table3/5, fig12/13, table6,
                  fig14–17, fig_adaptive) on the card, one cold engine that
                  traces each workload on the VM, into a
                  temporary directory: each CSV and JSON byte-identical to
                  the committed reference artifact; the full records of
                  the fig14–17 and fig_adaptive spaces and the adaptive run
                  (frontier, points priced per round) equal (==) to the
                  reference's; per artifact its wall seconds, the engine's
                  counters and the replay/placement launches, each launch
                  count equal to the builds that caused it; fig14's space
                  again from a warm store (no replay, no placement) and
                  under the process executor, two workers on the card;
  7. sampling  -- the sampled pipeline through the sampled ``CimBackend``
                  (``repro_torch.core.sampling``) on the card: the 17
                  workloads under the default spec in both modes (each plan
                  one full window), records == the reference's; KM@256
                  (7.6M virtual instructions) under the sampling
                  benchmark's synthetic spec in both modes, its plan,
                  marks, windowed columns (sha256), estimate and record ==
                  the reference's, with the ``sampling.*`` span seconds,
                  the skim rate and the replay/placement launches (one
                  replay; one placement per measured window with
                  candidates); the replay
                  kernel == ``CacheHierarchy.replay`` on KM@256's windowed
                  stream, and the sampled path's device time per kernel;
  9. service   -- the port's DSE daemon (``repro_torch.dse.service``) on
                  the card: the service benchmark's storm (8 clients x 2
                  requests over NB and LCS, ``python -m repro_torch.bench
                  service``'s defaults) against an in-process daemon: 384
                  points requested, 36 evaluated (== unique keys), dedup
                  10.667, at least one coalesced, 16 distinct trace ids,
                  a warm repeat with no build, evaluation or launch; one
                  request's Chrome trace (``chiprun_out/service_trace.json``)
                  and the storm's stage attribution; the fig14–17 spaces as
                  ``/v1/sweep`` requests, records == the reference's, and
                  again warm (no launch); fig_adaptive through the
                  service's event stream (in process: its 128K+2M geometry
                  has no preset name), rounds, frontier and records == the
                  reference's, and its preset part over HTTP, each record
                  == the reference's exhaustive one; KM@256 sampled
                  (stratified), record == the reference's; every replay
                  and placement launch equal to the builds that caused it;
                  a ``python -m repro_torch.dse.service`` process answering
                  one sweep and exiting 0 on SIGTERM;
  10. entry points -- the single-pass Algorithm 1
                  (``OffloadConfig(require_same_bank=True)`` and
                  ``OffloadConfig(allow_cross_level=False,
                  cim_levels=("L1",))``) on the 17 VM traces at 32K+256K,
                  priced in SRAM and FeFET: 68 records (candidate digest,
                  claimed count, the compared report fields) == the
                  committed ``reference_single_pass.json``, no placement
                  launch, with the selection seconds of each config beside
                  the two-phase path's on the same traces;
                  ``examples/torch_quickstart.py`` and
                  ``examples/torch_evaluate_workloads.py`` (SRAM, FeFET),
                  each a process of its own on the card, their lines ==
                  the reference examples' (the same fixture);
                  ``examples/torch_dse_cim.py --workload KM --cache-dir``
                  twice, the second run with no trace or selection build
                  and no launch; ``python -m repro_torch.bench timing
                  --workloads NB`` and its doc; each part's replay and
                  placement launches;
  11. serve    -- the model zoo's serving path (``repro_torch.models``,
                  no kernel: the reference's model path reaches no Pallas
                  kernel): the ten reduced archs and gemma3-1b at its
                  published widths cut to 6 layers (window 512 on five,
                  prompt 576), f32, prefill and 4 greedy decode steps on the
                  card from ``numpy_params``, tokens == and last-position
                  logits within 1e-4 of the committed
                  ``reference_serve.json``; then ``python -m
                  repro_torch.launch.serve --arch gemma3-1b --preset full``
                  (26 layers, bf16) as a process of its own, B=4, prompts of
                  64 and 1024 tokens, 32 generated: prefill ms, decode ms a
                  step, tokens/s, and the step's share of its bytes bound
                  (parameters + the KV each mask keeps + logits, at
                  3.35 TB/s);
  12. train    -- the model zoo's training path (``repro_torch.optim``,
                  ``train``, ``ckpt``, ``ft``, ``launch.train``; no kernel:
                  the reference trains by ``jax.grad`` through plain jnp):
                  the cases of ``reference_train.json`` (the ten reduced
                  archs, qwen1.5-0.5b with two microbatches and int8 error
                  feedback and with remat "block", gemma3-1b at its
                  published widths cut to 6 layers, sequence 576), f32,
                  trained on the card from ``numpy_params``, each step's
                  metrics and the final parameters held to the reference's;
                  ``python -m repro_torch.launch.train --arch gemma3-1b
                  --preset full`` (26 layers, bf16, B=4, S=1024, 8 steps,
                  remat "block") as a process of its own: step ms, tokens/s,
                  peak memory, the step's FLOPs beside the bf16 peak
                  (989 TFLOP/s), the final snapshot's bytes and seconds;
                  ``examples/torch_train_resume.py`` (a recovered failure,
                  then a fresh process resuming from step 29); the
                  reference's learnable-data check (qwen1.5-0.5b reduced,
                  40 steps, last loss below 0.7 of the first); one
                  full-width step profiled in process (device ms, kernels,
                  idle share);
  13. accelerator-mode DSE -- ``repro_torch.dse.TpuBackend`` on the card
                  (no kernel: the reference's accelerator-mode analysis
                  reaches no Pallas kernel): fig_tpu_dse's grid (4 reduced
                  archs x 3 chips x 3 thresholds, 36 points) with each
                  train step recorded as an ATen graph on the card, one
                  analysis per workload and 4 x 3 selections, then zero
                  analyses from a second engine on the same store; each
                  workload's eqns, candidates, TPU-MACR, FLOPs and
                  seconds; the backward seen by the recorder (more than 3x
                  the forward's products); the grid's 36 records and
                  Pareto front priced from the reference's analyses
                  (``reference_tpu_dse.json``) == the reference's; gemma3-1b
                  at its published widths (26 layers, bf16, B=4, S=1024)
                  analysed on the card: eqns, candidates, bytes, TPU-MACR,
                  FLOPs (== ``FlopCounterMode`` on the same step, beside
                  phase 12's analytic count), the recorder's seconds beside
                  a plain step's, peak memory; one ``"backend": "tpu"``
                  request through ``DSEService``, records == the engine's;
                  ``examples/torch_dse_cim.py --backend tpu`` as a process
                  (exit 0); no launch of K1-K8 over the phase;
  14. sharded path -- ``repro_torch.dist`` and ``launch`` (no kernel: the
                  reference's sharding, lowering and roofline reach no
                  Pallas kernel): the dry run at published widths, each
                  cell (gemma3-1b x train_4k, prefill_32k, decode_32k,
                  long_500k and moonshot-v1-16b-a3b x train_4k on the fake
                  (16, 16) mesh, yi-34b x train_4k on (2, 16, 16)) a
                  ``python -m repro_torch.launch.dryrun --check`` process,
                  all at once: record seconds, eqns, FLOPs, bytes and
                  collective bytes by kind per device, ok with collective
                  bytes > 0, and the FLOP checks (world-1 count ==
                  ``FlopCounterMode``; strategy "data" exactly world-1 / the
                  data split; "auto" between world-1 / devices and / the
                  data split); the spec trees of the ten archs == the
                  committed reference specs; ``cell_roofline`` == the
                  reference's rows on the committed records; ``python -m
                  repro_torch.bench roofline`` on this run's records;
                  ``launch.serve`` and ``launch.train`` (gemma3-1b reduced,
                  f32) with ``--model-parallel 2``, run as (1, 1): tokens
                  and losses == ``--model-parallel 1``; ``elastic_remesh()``
                  on the card gives (1, 1); no launch of K1-K8, summed
                  over the counts each dry-run and driver process reports
                  for its own run;
  15. result   -- the kernel table as one JSON line, the nvidia-smi line,
                  and ``{"ok": true, ...}`` as the last line.

Any mismatch, a kernel that its path never launched, or an exception
ends the run with a non-zero exit code and no ``ok`` line.  Without a CUDA
device it exits with code 2 before doing anything.  Longer output (the
compiler's register report, per-workload stage seconds) goes to
``chiprun_out/chip_smoke.json``.
"""
import collections
import contextlib
import ctypes
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parent
PROBES = ROOT / "probes" / "latency.cu"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, outside the tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM, dense tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM, dense tensor cores
# the kernels of repro_torch.core.accel that the main path launches; the
# segment reductions are held in phase 3 and by the tests
MAIN_PATH_KERNELS = ("replay", "place")


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


def turns_ms(kernel, library, reps):
    """(kernel ms, library ms), each the mean of two CUDA-event runs taken
    in turns -- kernel, library, library, kernel -- so a drift of the
    card's clock falls on both alike."""
    k1, l1 = event_ms(kernel, reps), event_ms(library, reps)
    l2, k2 = event_ms(library, reps), event_ms(kernel, reps)
    return (k1 + k2) / 2, (l1 + l2) / 2


def profiled_device_ms(fn, reps, names=None):
    """(device-only ms per call, CUDA kernels per call) of ``fn`` from a
    ``torch.profiler`` trace of ``reps`` calls: the summed time of the
    kernels the card ran, without the host's dispatch.  (None, 0) when the
    trace holds no device time.  ``names``, a dict, gets each device
    event's name and count per call.  The trace can miss an event (a run
    of 50 calls has read 0.98 kernels a call), so callers round a count
    per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            n += e.count
            if names is not None:
                names[e.key] = e.count / reps
    if us <= 0:
        return None, 0
    return us / 1e3 / reps, n / reps


def device_ms_by_kernel(fn):
    """({device event name: (summed device ms, count)}, host wall seconds)
    of one call of ``fn`` traced by ``torch.profiler`` (CUDA activity
    only); the dict is empty when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if t is None else t
            if us > 0:
                out[e.key] = (us / 1e3, e.count)
    return out, wall


def ptxas_summary(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: the entry's
    name, its registers, its stack frame and its spill bytes."""
    rows, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            m = re.search(r"\d+([a-z_]+?(?:kernel|smem))(?:I(\w+?)E)?E",
                          entry)
            if m:
                entry = m.group(1) + (f"<{m.group(2)}>" if m.group(2)
                                      else "")
        elif entry and "spill stores" in line:
            spill = ", ".join(x.strip() for x in line.split(","))
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            rows.append(f"{entry}: {regs}; {spill}")
            entry = None
    return rows


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def host_ms(fn, reps):
    """Mean host milliseconds of ``fn`` (CPU work, no device)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def placement_split(arrays_fn, lists_fn, join_fn, reps=20):
    """Where a placement call's time goes: the device work of ``arrays_fn``
    (from the profiler: kernels and copies per call, device ms per call),
    the host clock from the call until the four lists are on the host
    (``lists_fn``), and the host clock of the join with the protos alone
    (``join_fn``)."""
    names = {}
    dev_ms, _ = profiled_device_ms(arrays_fn, reps, names)
    copies = sum(n for k, n in names.items() if k.startswith("Mem"))
    return dict(device_ms=dev_ms,
                kernels_per_call=sum(names.values()) - copies,
                copies_per_call=copies, lists_ms=host_ms(lists_fn, reps),
                join_ms=host_ms(join_fn, reps), device_events=names)


# a synthetic placement: runs the fixtures do not have
SYNTHETIC_RUN = 1100


def synthetic_placement(seed):
    """(partition, CPU trace columns) with protos of no leaves, no loads (bank
    None), no accesses, and runs of 1, 33 and SYNTHETIC_RUN accesses among
    200 random ones, MEM and non-MEM accesses mixed in each run, lines
    repeated, addresses up to 2**50."""
    gen = torch.Generator().manual_seed(seed)
    n_inst = 4096
    lines = torch.randint(0, 2 ** 44, (64,), generator=gen)
    addr = (lines[torch.randint(0, 64, (n_inst,), generator=gen)] * 64
            + torch.randint(0, 64, (n_inst,), generator=gen))
    cols = types.SimpleNamespace(
        level=torch.randint(0, 4, (n_inst,), generator=gen,
                            dtype=torch.int8),
        addr=addr, bank=torch.randint(0, 16, (n_inst,), generator=gen,
                                      dtype=torch.int16),
        device=torch.device("cpu"), _struct={})

    def seqs(k):
        return torch.randint(0, n_inst, (k,), generator=gen).tolist()

    def proto(n_leaf, n_load, n_store):
        return types.SimpleNamespace(leaf_src=seqs(n_leaf),
                                     load_seqs=seqs(n_load),
                                     store_seqs=seqs(n_store))

    protos = [proto(0, 3, 1), proto(5, 0, 4), proto(2, 0, 0),
              proto(1, 1, 0), proto(40, 20, 13),
              proto(70, SYNTHETIC_RUN - 300, 300)]
    for _ in range(200):
        k = int(torch.randint(0, 40, (1,), generator=gen))
        protos.append(proto(int(torch.randint(0, 9, (1,), generator=gen)),
                            k, int(torch.randint(0, 3, (1,), generator=gen))))
    return types.SimpleNamespace(protos=protos), cols


def bytes_bound_ms(n_bytes, n_ops, ops_per_s=FP32_OPS_PER_S):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak rate of their type (default: fp32 outside
    the tensor cores)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# gemma3-1b's attention (src/repro/configs/gemma3_1b.py) and xlstm-125m's
# mLSTM (src/repro/configs/xlstm_125m.py), at their published widths
GEMMA = dict(layers=26, heads=4, kv_heads=1, head_dim=256, window=512,
             global_every=6, batch=1, seq=4096)
XLSTM = dict(blocks=6, heads=4, head_dim=192, chunk=128, batch=8, seq=2048)
BULK_SHAPE = (4096, 8192)          # int32: 128 MiB per operand
BULK_OPS = ("and", "or", "xor", "add", "sub")
# (atol, rtol) of |kernel - plain| <= atol + rtol * |plain|.  f32: the
# reference tests' own bounds.  bf16: both sides compute in f32 from the
# same bf16 inputs and round once, so they differ by about one bf16 ulp
# (at most 2**-7 of the value) plus the f32 gap.
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-3, 1e-2)}
MLSTM_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (2e-3, 1e-2)}


def layer_windows(cfg):
    """Per-layer window (0 = global), as repro.models.transformer does."""
    w = [cfg["window"]] * cfg["layers"]
    for i in range(cfg["global_every"] - 1, cfg["layers"],
                   cfg["global_every"]):
        w[i] = 0
    return w


def unmasked_scores(sq, skv, window):
    """Scores that the causal mask (and a window > 0) leave live, for sq
    query rows over skv keys."""
    return sum(min(q + 1, skv) if window <= 0 else min(q + 1, skv, window)
               for q in range(sq))


def allclose_err(got, want, tol):
    """(max |got - want|, max |got - want| / (atol + rtol * |want|)) for
    ``tol = (atol, rtol)``: the second is at most 1 where they agree."""
    a, b = got.detach().cpu().float(), want.float()
    diff = (a - b).abs()
    return float(diff.max()), float((diff / (tol[0] + tol[1] * b.abs())).max())


def cim_kernels_phase(dev):
    """Phase 5: the CiM kernels through ``repro_torch.kernels.ops``."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(5)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ints(shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    g, x = GEMMA, XLSTM
    windows = layer_windows(g)
    attn_in = {dt: [tuple(normal(g["batch"], h, g["seq"], g["head_dim"],
                                 dtype=dt)
                          for h in (g["heads"], g["kv_heads"], g["kv_heads"]))
                    for _ in windows]
               for dt in (torch.float32, torch.bfloat16)}
    mlstm_in = [(*(normal(x["batch"], x["heads"], x["seq"], x["head_dim"])
                   for _ in range(3)),
                 normal(x["batch"], x["heads"], x["seq"]),
                 normal(x["batch"], x["heads"], x["seq"]) + 3.0)
                for _ in range(x["blocks"])]
    bx, by, bz = ints(BULK_SHAPE), ints(BULK_SHAPE), ints(BULK_SHAPE)
    torch.cuda.synchronize()

    # ---- the counted run: one prefill's launches of each kernel
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    attn_out = {dt: [ops.flash_attention(q, k, v, causal=True, window=w)
                     for (q, k, v), w in zip(ins, windows)]
                for dt, ins in attn_in.items()}
    mlstm_out = [ops.mlstm_chunkwise(*a, chunk=x["chunk"]) for a in mlstm_in]
    bulk_out = {(op, dt): ops.cim_bulk(bx.view(dt), by.view(dt), op=op)
                for dt in (torch.int32, torch.uint32) for op in BULK_OPS}
    fused_out = {dt: ops.cim_fused(bx.view(dt), by.view(dt), bz.view(dt),
                                   op1="add", op2="xor")
                 for dt in (torch.int32, torch.uint32)}
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect = {"flash_attention": 2 * g["layers"],
              "mlstm_chunkwise": x["blocks"],
              "cim_bitwise": 2 * len(BULK_OPS), "cim_bitwise_fused": 2}
    print(f"kernels path: {path_s:.2f} s wall; launches "
          + json.dumps(launches), flush=True)
    for name in kernels.KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was never launched on the kernels path")
    if launches != expect:
        fail(f"kernels path launches {launches}, expected {expect}")

    # ---- each kernel against its plain version, on CPU copies
    # max |kernel - plain| per kernel; bf16 results are held apart
    err = dict.fromkeys((*kernels.KERNELS, "flash_attention bf16",
                         "mlstm_chunkwise bf16"), 0.0)
    share_of_tol = dict.fromkeys(err, 0.0)

    def check_int(name, got, want, what):
        a, b = got.cpu().view(torch.int32), want.view(torch.int32)
        if got.dtype != want.dtype or not torch.equal(a, b):
            fail(f"{name} differs from its plain version on {what}")
        err[name] = max(err[name], float(
            (a.to(torch.int64) - b.to(torch.int64)).abs().max()))

    for (op, dt), got in bulk_out.items():
        check_int("cim_bitwise", got, ops.cim_bulk(
            bx.view(dt).cpu(), by.view(dt).cpu(), op=op),
                  f"{op} {dt} {BULK_SHAPE}")
    for dt, got in fused_out.items():
        check_int("cim_bitwise_fused", got, ops.cim_fused(
            bx.view(dt).cpu(), by.view(dt).cpu(), bz.view(dt).cpu()),
                  f"add/xor {dt} {BULK_SHAPE}")
    cpu_gen = torch.Generator().manual_seed(6)
    for dt in (torch.int32, torch.uint32):     # tests/test_kernels.py shapes
        for shape in ((8, 128), (100, 300), (17, 1000), (1, 64)):
            a, b = (torch.randint(0, 2 ** 20, shape, generator=cpu_gen,
                                  dtype=torch.int32).view(dt)
                    for _ in range(2))
            for op in BULK_OPS:
                check_int("cim_bitwise", ops.cim_bulk(
                    a.to(dev), b.to(dev), op=op), ops.cim_bulk(a, b, op=op),
                          f"{op} {dt} {shape}")
    a, b, c = (torch.randint(0, 2 ** 16, (64, 256), generator=cpu_gen,
                             dtype=torch.int32) for _ in range(3))
    check_int("cim_bitwise_fused", ops.cim_fused(
        a.to(dev), b.to(dev), c.to(dev)), ops.cim_fused(a, b, c),
              "add/xor (64, 256)")

    def check_float(name, got, want, tol, what):
        e, share = allclose_err(got, want, tol)
        print(f"  {name} {what}: max_abs_err {e:.3g} (atol {tol[0]:g}, "
              f"rtol {tol[1]:g}; {share:.3f} of the tolerance)", flush=True)
        if not share <= 1.0:
            fail(f"{name} differs from its plain version on {what} beyond "
                 f"atol {tol[0]:g}, rtol {tol[1]:g}: max_abs_err {e}")
        key = f"{name} bf16" if got.dtype == torch.bfloat16 else name
        err[key] = max(err[key], e)
        share_of_tol[key] = max(share_of_tol[key], share)

    first_global = windows.index(0)
    for dt in (torch.float32, torch.bfloat16):
        for li in (0, first_global):
            q, k, v = (t.cpu() for t in attn_in[dt][li])
            check_float("flash_attention", attn_out[dt][li],
                        ops.flash_attention(q, k, v, causal=True,
                                            window=windows[li]),
                        FLASH_TOL[dt],
                        f"gemma3-1b layer {li} (window {windows[li]}) {dt}")
    check_float("mlstm_chunkwise", mlstm_out[0], ops.mlstm_chunkwise(
        *(t.cpu() for t in mlstm_in[0]), chunk=x["chunk"]),
                MLSTM_TOL[torch.float32], "xlstm-125m block 0")
    for B, H, Hkv, S, d in ((1, 2, 2, 128, 32), (2, 4, 2, 256, 64),
                            (1, 8, 1, 128, 64)):
        for window in (0, 32):
            q = torch.randn(B, H, S, d, generator=cpu_gen)
            k, v = (torch.randn(B, Hkv, S, d, generator=cpu_gen)
                    for _ in range(2))
            check_float("flash_attention", ops.flash_attention(
                q.to(dev), k.to(dev), v.to(dev), window=window, block_q=64,
                block_k=64), ops.flash_attention(
                q, k, v, window=window, block_q=64, block_k=64),
                        FLASH_TOL[torch.float32],
                        f"{(B, H, Hkv, S, d)} window {window}")
    q, k, v = (torch.randn(1, 2, 128, 64, generator=cpu_gen).to(
        torch.bfloat16) for _ in range(3))
    check_float("flash_attention", ops.flash_attention(
        q.to(dev), k.to(dev), v.to(dev), block_q=64, block_k=64),
                ops.flash_attention(q, k, v, block_q=64, block_k=64),
                FLASH_TOL[torch.bfloat16], "(1, 2, 2, 128, 64) bf16")
    q = torch.randn(1, 2, 100, 32, generator=cpu_gen)  # ragged, Sq > Skv
    k, v = (torch.randn(1, 2, 70, 32, generator=cpu_gen) for _ in range(2))
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        check_float("flash_attention", ops.flash_attention(
            qd.to(dev), kd.to(dev), vd.to(dev), block_q=64, block_k=64),
                    ops.flash_attention(qd, kd, vd, block_q=64, block_k=64),
                    FLASH_TOL[dt], f"ragged Sq=100 > Skv=70 {dt}")
    for B, H, Hkv, S, d, window in ((2, 4, 2, 256, 64, 32),
                                    (1, 8, 2, 256, 128, 0)):  # bf16 GQA
        q = torch.randn(B, H, S, d, generator=cpu_gen).to(torch.bfloat16)
        k, v = (torch.randn(B, Hkv, S, d, generator=cpu_gen)
                .to(torch.bfloat16) for _ in range(2))
        check_float("flash_attention", ops.flash_attention(
            q.to(dev), k.to(dev), v.to(dev), window=window, block_q=64,
            block_k=64), ops.flash_attention(
            q, k, v, window=window, block_q=64, block_k=64),
                    FLASH_TOL[torch.bfloat16],
                    f"{(B, H, Hkv, S, d)} window {window} bf16")
    for B, H, S, dh, chunk in ((1, 1, 64, 16, 16), (2, 2, 128, 32, 32),
                               (1, 2, 128, 64, 64)):
        a = (*(torch.randn(B, H, S, dh, generator=cpu_gen)
               for _ in range(3)),
             torch.randn(B, H, S, generator=cpu_gen),
             torch.randn(B, H, S, generator=cpu_gen) + 3.0)
        check_float("mlstm_chunkwise", ops.mlstm_chunkwise(
            *(t.to(dev) for t in a), chunk=chunk), ops.mlstm_chunkwise(
            *a, chunk=chunk), MLSTM_TOL[torch.float32],
                    f"{(B, H, S, dh)} chunk {chunk}")
    # bf16 q/k/v at xlstm-125m's width, two chunks of a short sequence
    a = (*(torch.randn(2, x["heads"], 256, x["head_dim"], generator=cpu_gen)
           .to(torch.bfloat16) for _ in range(3)),
         torch.randn(2, x["heads"], 256, generator=cpu_gen),
         torch.randn(2, x["heads"], 256, generator=cpu_gen) + 3.0)
    check_float("mlstm_chunkwise", ops.mlstm_chunkwise(
        *(t.to(dev) for t in a), chunk=x["chunk"]), ops.mlstm_chunkwise(
        *a, chunk=x["chunk"]), MLSTM_TOL[torch.bfloat16],
                f"(2, {x['heads']}, 256, {x['head_dim']}) bf16")

    # ---- times: kernel (events), plain version (host), bound, library
    table = {}
    n_bulk = bx.numel()
    bulk_bytes = n_bulk * bx.element_size()
    xc, yc, zc = bx.cpu(), by.cpu(), bz.cpu()
    variants = {}
    # 200 calls a timing: the host's enqueue of the first call, which the
    # card waits for once per timing, is then under 0.1% of the total
    for op, lib in (("and", torch.bitwise_and), ("add", torch.add)):
        ms, lib_ms = turns_ms(lambda: ops.cim_bulk(bx, by, op=op),
                              lambda: lib(bx, by), 200)
        plain = host_ms(lambda: ops.cim_bulk(xc, yc, op=op), 3)
        variants[op] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms)
        print(f"cim_bitwise {op} {BULK_SHAPE} int32: {ms:.4f} ms kernel, "
              f"{lib_ms:.4f} ms library, {plain:.2f} ms plain (host)",
              flush=True)
    bound, by_ = bytes_bound_ms(3 * bulk_bytes, n_bulk)
    for op, v in variants.items():
        v["bound_share"] = bound / v["ms"]
        print(f"cim_bitwise {op}: {v['bound_share']:.3f} of the bytes bound "
              f"{bound:.4f} ms (library {bound / v['library_ms']:.3f})",
              flush=True)
    table["cim_bitwise"] = dict(
        source="src/repro_torch/kernels/csrc/cim_bitwise.cu",
        replaces="src/repro/kernels/cim_bitwise.py:36",
        twin="src/repro/kernels/cim_bitwise.py::cim_bitwise",
        equal=True, tolerance=0, **variants["and"], bound_ms=bound,
        bound_by=by_,
        library_call="torch.bitwise_and", variants=variants,
        shape=f"{BULK_SHAPE} int32, op and")
    ms = event_ms(lambda: ops.cim_fused(bx, by, bz), 200)
    plain = host_ms(lambda: ops.cim_fused(xc, yc, zc), 3)
    bound, by_ = bytes_bound_ms(4 * bulk_bytes, 2 * n_bulk)
    table["cim_bitwise_fused"] = dict(
        source="src/repro_torch/kernels/csrc/cim_bitwise.cu",
        replaces="src/repro/kernels/cim_bitwise.py:64",
        twin="src/repro/kernels/cim_bitwise.py::cim_bitwise_fused",
        equal=True, tolerance=0, ms=ms, plain_ms=plain, library_ms=None,
        bound_ms=bound, bound_by=by_, bound_share=bound / ms,
        shape=f"{BULK_SHAPE} int32, (x add y) xor z")
    print(f"cim_bitwise_fused {BULK_SHAPE} int32: {ms:.4f} ms kernel, "
          f"{plain:.2f} ms plain (host); {bound / ms:.3f} of the bytes "
          f"bound {bound:.4f} ms", flush=True)

    S, d = g["seq"], g["head_dim"]
    band = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    band = band & ~torch.ones_like(band).tril(-g["window"])
    variants = {}
    for dt in (torch.float32, torch.bfloat16):
        for li, kind in ((first_global, "global"), (0, "window")):
            q, k, v = attn_in[dt][li]
            w = windows[li]
            if w:
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=band, enable_gqa=True)
            else:
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            ms, lib_ms = turns_ms(
                lambda: ops.flash_attention(q, k, v, window=w), lib, 10)
            qc_, kc_, vc_ = q.cpu(), k.cpu(), v.cpu()
            plain = host_ms(lambda: ops.flash_attention(qc_, kc_, vc_,
                                                        window=w), 1)
            n_ops = 4 * d * g["batch"] * g["heads"] * unmasked_scores(S, S, w)
            n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
            key = f"{str(dt).split('.')[-1]} {kind}"
            if dt == torch.float32:
                # f32 runs its products as 3xTF32: three TF32 products each
                # on the tensor cores; the same flops in f32 outside them
                # are printed beside it
                bound, by_ = bytes_bound_ms(n_bytes, 3 * n_ops,
                                            TF32_OPS_PER_S)
                f32_bound, _ = bytes_bound_ms(n_bytes, n_ops)
                extra = dict(f32_bound_ms=f32_bound,
                             f32_bound_share=f32_bound / ms)
                bounds = (f"bound {bound:.4f} ms ({by_}, 3xTF32 on the "
                          f"tensor cores; {bound / ms:.3f} of it), the same "
                          f"flops in f32 outside the tensor cores "
                          f"{f32_bound:.4f} ms ({f32_bound / ms:.3f} of it)")
            else:
                bound, by_ = bytes_bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
                extra = {}
                bounds = f"bound {bound:.4f} ms ({by_})"
            variants[key] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                                 bound_ms=bound, bound_by=by_,
                                 bound_share=bound / ms, flop=n_ops, **extra)
            print(f"flash_attention {key} (window {w}): {ms:.4f} ms kernel, "
                  f"{lib_ms:.4f} ms library ({ms / lib_ms:.2f}x; in "
                  f"turns), {plain:.1f} ms plain (host), {bounds}",
                  flush=True)
        ins = attn_in[dt]
        prefill = event_ms(lambda: [ops.flash_attention(q, k, v, window=w)
                                    for (q, k, v), w in zip(ins, windows)],
                           2)
        name = str(dt).split('.')[-1]
        n_window = sum(1 for w in windows if w)
        per_layer = {x: variants[f"{name} {x}"] for x in ("global", "window")}
        pre = dict(ms=prefill, **{
            b: (len(windows) - n_window) * per_layer["global"][b]
            + n_window * per_layer["window"][b]
            for b in ("bound_ms", "f32_bound_ms") if b in per_layer["window"]})
        variants[f"{name} prefill"] = pre
        print(f"flash_attention {dt} prefill ({g['layers']} launches): "
              f"{prefill:.3f} ms; summed bound {pre['bound_ms']:.4f} ms ("
              f"{pre['bound_ms'] / prefill:.3f} of it)"
              + (f", in f32 outside the tensor cores "
                 f"{pre['f32_bound_ms']:.4f} ms "
                 f"({pre['f32_bound_ms'] / prefill:.3f} of it)"
                 if "f32_bound_ms" in pre else ""), flush=True)
    for key, name, dt in (("flash_attention", "f32", torch.float32),
                          ("flash_attention bf16", "bf16",
                           torch.bfloat16)):
        print(f"flash_attention {name}: max_abs_err {err[key]:.3g}, "
              f"{share_of_tol[key]:.3f} of the tolerance (atol "
              f"{FLASH_TOL[dt][0]:g}, rtol {FLASH_TOL[dt][1]:g})",
              flush=True)
    top = variants["float32 global"]
    table["flash_attention"] = dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:71",
        twin="src/repro/kernels/flash_attention.py::flash_attention",
        within_tolerance=True, tolerance=FLASH_TOL[torch.float32], **{
            k_: top[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "f32_bound_ms",
                                   "bound_share", "f32_bound_share")},
        share_of_tolerance=share_of_tol["flash_attention"],
        bf16_tolerance=FLASH_TOL[torch.bfloat16],
        bf16_max_abs_err=err["flash_attention bf16"],
        bf16_share_of_tolerance=share_of_tol["flash_attention bf16"],
        library_call="F.scaled_dot_product_attention (enable_gqa; causal, "
                     "or a boolean band mask for window 512)",
        launches_per_prefill=g["layers"], variants=variants,
        shape=f"gemma3-1b: B={g['batch']}, H={g['heads']}, "
              f"Hkv={g['kv_heads']}, S={S}, d={d}; f32 global layer")

    a = mlstm_in[0]
    # 20 calls: the host's enqueue of the first, which the card waits for
    # once per timing, stays a small part of the mean
    ms = event_ms(lambda: ops.mlstm_chunkwise(*a, chunk=x["chunk"]), 20)
    a_cpu = [t.cpu() for t in a]
    plain = host_ms(lambda: ops.mlstm_chunkwise(*a_cpu, chunk=x["chunk"]), 1)
    K, dh, S = x["chunk"], x["head_dim"], x["seq"]
    chains = x["batch"] * x["heads"]
    # per chunk: q.k^T and w.v over the causal pairs j <= t, 2*dh each,
    # and q.C and k^T.v, 2*K*dh^2 each
    chunk_flop = 4 * dh * (K * (K + 1) // 2) + 4 * K * dh * dh
    n_ops = chunk_flop * chains * (S // K)
    n_bytes = sum(t.numel() * t.element_size() for t in a) \
        + a[0].numel() * a[0].element_size()
    # the kernel runs the products as 3xTF32: three TF32 products each on
    # the tensor cores; the same flops in f32 outside them, and one SM per
    # chain at that rate (the floor of a one-block-per-chain design), are
    # printed beside it
    bound, by_ = bytes_bound_ms(n_bytes, 3 * n_ops, TF32_OPS_PER_S)
    f32_bound, _ = bytes_bound_ms(n_bytes, n_ops)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chain_floor = chunk_flop * (S // K) / (FP32_OPS_PER_S / sms) * 1e3
    prefill = event_ms(lambda: [ops.mlstm_chunkwise(*b, chunk=K)
                                for b in mlstm_in], 2)
    table["mlstm_chunkwise"] = dict(
        source="src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        replaces="src/repro/kernels/mlstm_chunk.py:82",
        twin="src/repro/kernels/mlstm_chunk.py::mlstm_chunkwise",
        within_tolerance=True, tolerance=MLSTM_TOL[torch.float32], ms=ms,
        plain_ms=plain, library_ms=None,
        bf16_tolerance=MLSTM_TOL[torch.bfloat16],
        bf16_max_abs_err=err["mlstm_chunkwise bf16"],
        bound_ms=bound, bound_by=by_, f32_bound_ms=f32_bound,
        chain_bound_ms=chain_floor,
        launches_per_prefill=x["blocks"], prefill_ms=prefill,
        shape=f"xlstm-125m: B={x['batch']}, H={x['heads']}, S={S}, "
              f"dh={dh}, chunk {K}, f32")
    mlstm_events, _ = device_ms_by_kernel(
        lambda: ops.mlstm_chunkwise(*a, chunk=x["chunk"]))
    table["mlstm_chunkwise"]["device_events"] = {
        k: dict(ms=v[0], count=v[1]) for k, v in mlstm_events.items()}
    print(f"mlstm_chunkwise: {ms:.3f} ms kernel, {plain:.1f} ms plain "
          f"(host); bound {bound:.4f} ms ({by_}, 3xTF32 on the tensor "
          f"cores; {bound / ms:.3f} of it), the same flops in f32 outside "
          f"the tensor cores {f32_bound:.4f} ms ({f32_bound / ms:.3f} of "
          f"it), one-SM-per-chain floor {chain_floor:.4f} ms "
          f"({ms / chain_floor:.3f}x); prefill ({x['blocks']} launches) "
          f"{prefill:.3f} ms; device events of one call (profiler) "
          + json.dumps({k[:50]: round(v[0], 4)
                        for k, v in mlstm_events.items()}), flush=True)
    for name in kernels.KERNELS:
        table[name]["max_abs_err"] = err[name]
    return table, launches, path_s


def trace_phase(dev):
    """Phase 3b: each workload traced on the port's VM, its columns on
    ``dev``, held to the committed reference trace.  Returns
    ({name: StructuralTrace}, summary for the detail file)."""
    import numpy as np
    from repro_torch.core.trace import trace_structural
    from repro_torch.workloads import build, fixtures

    traces, per_workload, failures = {}, {}, []
    t_all = time.perf_counter()
    for name in fixtures.WORKLOADS:
        t0 = time.perf_counter()
        fn, args = build(name)
        st = trace_structural(fn, *args, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        traces[name] = st
        want = fixtures.load_arrays(name)
        have = st.columns.to_arrays()
        bad = [k for k in have if have[k].dtype != want[k].dtype
               or not np.array_equal(have[k], want[k])]
        n_out = int(want["meta_n_outputs"][0])
        if len(st.outputs) != n_out:
            bad.append(f"{len(st.outputs)} outputs, want {n_out}")
        for i, out in enumerate(st.outputs[:n_out]):
            got, ref = out.numpy(), want[f"out_{i}"]
            if ref.dtype.kind == "f":
                ok = got.shape == ref.shape and bool(
                    np.all(np.abs(got - ref) <= 1e-4 + 1e-4 * np.abs(ref)))
            else:
                ok = got.dtype == ref.dtype and np.array_equal(got, ref)
            if not ok:
                bad.append(f"out_{i}")
        per_workload[name] = dict(seconds=secs,
                                  instructions=st.n_instructions,
                                  differs=bad)
        print(f"  {name:8s} {st.n_instructions:6d} instructions "
              f"{secs:7.3f} s  {'== reference' if not bad else bad}",
              flush=True)
        if bad:
            failures.append(f"{name}: {bad}")
    total = time.perf_counter() - t_all
    n_inst = sum(v["instructions"] for v in per_workload.values())
    print(f"trace frontend: {len(traces)} workloads, {n_inst} instructions "
          f"in {total:.3f} s (host), columns on "
          f"{torch.cuda.get_device_name(0)}; "
          f"{len(traces) - len(failures)} of {len(traces)} == reference",
          flush=True)
    return traces, dict(per_workload=per_workload, total_s=total,
                        instructions=n_inst, failures=failures)


def fresh(st):
    """``st`` with the same columns and an empty derived-table memo, so a
    second sweep builds its IDG and flow tables anew."""
    from repro_torch.core.columnar import COLUMNS, ColumnarTrace
    from repro_torch.core.trace import StructuralTrace
    ct = st.columns
    return StructuralTrace(ColumnarTrace(
        ct.n, n_regs=ct.n_regs, **{c: getattr(ct, c) for c in COLUMNS}),
        st.outputs)


def dse_phase(dev):
    """Phase 6: the paper artifacts, the sweep records, the adaptive run,
    a warm store and the process executor, all on ``dev``.  Returns
    (summary for the detail file, the phase's replay/place launches)."""
    from repro_torch.bench import common, run as bench_run
    from repro_torch.core import accel
    from repro_torch.dse import AdaptiveDSE, DSEEngine
    from repro_torch.workloads import fixtures

    def counters(cache):
        return dict(cache.stats(), single_replays=cache.single_replays)

    def delta(a, b):
        return {k: b[k] - a.get(k, 0) for k in b
                if not k.startswith("store_bytes")}

    ref_records = fixtures.reference_records()
    summary, failures = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as out:
        common.configure(device=dev, out=out)
        eng = common.engine()
        per_artifact = {}
        accel.reset_launch_counts()
        t_all = time.perf_counter()
        for name, mod in bench_run.CIM.items():
            c0, l0 = counters(eng.analysis), accel.launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                mod.main()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = delta(c0, counters(eng.analysis))
            l1 = accel.launch_counts()
            k1, k4 = l1["replay"] - l0["replay"], l1["place"] - l0["place"]
            want_k1 = d["replay_batches"] + d["single_replays"]
            # a core-level driver's own placements, outside the engine's
            # offload layer, are one K4 launch each
            direct = getattr(mod, "DIRECT_SELECTIONS", 0)
            want_k4 = d["offload_builds"] + direct
            stem = bench_run.stem(name)
            same = {f: (pathlib.Path(out) / f).read_bytes()
                    == (fixtures.ARTIFACTS_DIR / f).read_bytes()
                    for f in (f"{stem}.csv", f"{stem}.json")}
            per_artifact[name] = dict(wall_s=wall, replay=k1, place=k4,
                                      byte_identical=all(same.values()),
                                      **d)
            print(f"  {name:12s} {wall:7.3f} s  replay {k1:3d} (batches "
                  f"{d['replay_batches']} + single {d['single_replays']})"
                  f"  place {k4:3d} (offload builds {d['offload_builds']} "
                  f"+ direct {direct})  "
                  f"{'identical' if all(same.values()) else 'DIFFERS'}",
                  flush=True)
            if not all(same.values()):
                failures.append(f"{name}: artifact differs {same}")
            if k1 != want_k1 or k4 != want_k4:
                failures.append(f"{name}: launches replay {k1} / place {k4}"
                                f", builds say {want_k1} / {want_k4}")
        runner_wall = time.perf_counter() - t_all
        launches = {k: accel.launch_counts()[k] for k in ("replay", "place")}
        stats = counters(eng.analysis)
    print(f"DSE runner: 10 artifacts in {runner_wall:.3f} s wall on "
          f"{torch.cuda.get_device_name(0)}; launches "
          + json.dumps(launches) + "; engine " + json.dumps(stats),
          flush=True)
    if min(launches.values()) <= 0:
        failures.append(f"a kernel of the DSE path never launched: "
                        f"{launches}")
    sweeps = bench_run.SWEEPS
    sweep_k4 = sum(per_artifact[n]["place"] for n in sweeps)
    sweep_builds = sum(per_artifact[n]["offload_builds"] for n in sweeps)
    if sweep_k4 != sweep_builds:
        failures.append(f"sweep artifacts: {sweep_k4} placements, "
                        f"{sweep_builds} offload builds")

    # the full records of each sweep space and the adaptive run
    t0 = time.perf_counter()
    for name in sweeps:
        got = [r.to_dict() for r in eng.run(bench_run.ALL[name].space())]
        if got != ref_records[name]:
            failures.append(f"{name}: records differ from the reference")
    fa = bench_run.ALL["fig_adaptive"]
    ad = AdaptiveDSE(fa.space(), engine=eng, objectives=fa.OBJECTIVES).run()
    rounds = [{"round": r.round, "n_candidates": r.n_candidates,
               "n_priced": r.n_priced, "frontier_size": r.frontier_size,
               "stable": r.stable} for r in ad.rounds]
    want = ref_records["adaptive"]
    adaptive_equal = (rounds == want["rounds"]
                      and [r.to_dict() for r in ad.frontier]
                      == want["frontier"]
                      and [r.to_dict() for r in ad.results]
                      == want["records"])
    if not adaptive_equal:
        failures.append("adaptive run differs from the reference")
    n_records = sum(len(ref_records[n]) for n in sweeps)
    print(f"records: {n_records} of the five sweep spaces and "
          f"{len(want['records'])} of the adaptive run compared (==) in "
          f"{time.perf_counter() - t0:.3f} s; adaptive priced "
          f"{[r['n_priced'] for r in rounds]} per round, frontier "
          f"{len(ad.frontier)}", flush=True)

    # fig14's space from a warm store, and under two process workers
    space = bench_run.ALL["fig14"].space()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as d:
        DSEEngine(store=d, device=dev).run(space)
        accel.reset_launch_counts()
        t0 = time.perf_counter()
        warm = DSEEngine(store=d, device=dev).run(space)
        warm_s = time.perf_counter() - t0
        warm_launches = accel.launch_counts()
    print(f"warm store: trace_builds {warm.stats['trace_builds']}, "
          f"offload_builds {warm.stats['offload_builds']}, launches replay "
          f"{warm_launches['replay']} place {warm_launches['place']}, "
          f"{warm_s:.3f} s", flush=True)
    if (warm.stats["trace_builds"] or warm.stats["offload_builds"]
            or warm_launches["replay"] or warm_launches["place"]
            or [r.to_dict() for r in warm] != ref_records["fig14"]):
        failures.append("warm-store rerun built, replayed, placed or "
                        "differed")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_workers_") as d:
        peng = DSEEngine(executor="process", max_workers=2, store=d,
                         device=dev)
        t0 = time.perf_counter()
        pres = peng.run(space)
        proc_s = time.perf_counter() - t0
    print(f"process executor: 2 workers on the card, {proc_s:.3f} s; "
          f"worker launches {json.dumps(peng.worker_launches)}; "
          f"trace_builds {pres.stats['trace_builds']}, offload_builds "
          f"{pres.stats['offload_builds']}", flush=True)
    if ([r.to_dict() for r in pres] != ref_records["fig14"]
            or peng.worker_launches["replay"] != pres.stats["trace_builds"]
            or peng.worker_launches["place"] != pres.stats["offload_builds"]
            or min(peng.worker_launches.values()) <= 0):
        failures.append("process executor: records or worker launches")

    summary.update(per_artifact=per_artifact, runner_wall_s=runner_wall,
                   launches=launches, engine=stats, rounds=rounds,
                   adaptive_equal=adaptive_equal, warm_store_s=warm_s,
                   warm_stats=warm.stats, warm_launches=warm_launches,
                   process_s=proc_s, process_stats=pres.stats,
                   worker_launches=peng.worker_launches, failures=failures)
    return summary, launches


def sampling_phase(dev):
    """Phase 7: the sampled pipeline on ``dev`` through the sampled
    ``CimBackend``: the 17 workloads under the default spec (full
    coverage) and KM@256 under the benchmark's synthetic spec, both modes,
    held (==) to the reference's committed results; K1 held (==) to the
    plain replay on KM@256's windowed stream.  Returns (summary for the
    detail file, this phase's replay/place launches, K1's comparison)."""
    from repro_torch import obs
    from repro_torch.bench.sampling import SYNTH_SPEC
    from repro_torch.core import accel
    from repro_torch.core.accel.replay import replay_columns_batch
    from repro_torch.core.cache import L1_32K, L2_256K, CacheHierarchy
    from repro_torch.core.isa import OP_STORE
    from repro_torch.core.offload import OffloadConfig
    from repro_torch.core.sampling import (SamplingSpec, attach_sampled,
                                           price_sampled, select_sampled)
    from repro_torch.dse import CimBackend, DSEEngine, SweepSpace
    from repro_torch.workloads import fixtures

    want = fixtures.reference_sampled()
    modes = ("stratified", "phase")
    failures, summary = [], {"suite": {}, "synthetic": {}}
    launches = dict.fromkeys(MAIN_PATH_KERNELS, 0)

    def counted(fn):
        accel.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: accel.launch_counts()[k] for k in MAIN_PATH_KERNELS}
        for k in MAIN_PATH_KERNELS:
            launches[k] += got[k]
        return out, got

    # (a) the 17 workloads, default spec: each plan is one full window
    techs = tuple(want["suite"]["techs"])
    for mode in modes:
        eng = DSEEngine(device=dev, backend=CimBackend(
            sampling=SamplingSpec(mode=mode)))
        t0 = time.perf_counter()
        res, got = counted(lambda: eng.run(SweepSpace(
            workloads=fixtures.WORKLOADS, techs=techs)))
        secs = time.perf_counter() - t0
        recs = [r.to_dict() for r in res]
        ref_recs = want["suite"]["records"][mode]
        equal = sum(a == b for a, b in zip(recs, ref_recs))
        n = len(ref_recs)
        summary["suite"][mode] = dict(seconds=secs, records=len(recs),
                                      equal=equal, launches=got,
                                      stats=res.stats)
        print(f"  suite {mode:10s} {len(recs)} records, {equal} of {n} == "
              f"reference, {secs:.3f} s; launches {json.dumps(got)}",
              flush=True)
        if len(recs) != n or equal != n:
            failures.append(f"suite {mode}: {equal} of {n} records equal")

    # (b) KM@256 under the synthetic spec, through the engine; its memoized
    # artifacts give the plan, the windows and the estimate
    levels = (L1_32K, L2_256K)
    for mode in modes:
        spec = SamplingSpec(mode=mode, **SYNTH_SPEC)
        backend = CimBackend(sampling=spec)
        eng = DSEEngine(device=dev, backend=backend)
        space = SweepSpace(workloads=("KM@256",))
        tracer = obs.enable()
        t0 = time.perf_counter()
        res, got = counted(lambda: eng.run(space))
        secs = time.perf_counter() - t0
        spans = {}
        for sp in tracer.spans():
            if sp["name"].startswith("sampling."):
                key = sp["name"].split(".", 1)[1]
                spans[key] = spans.get(key, 0.0) + sp["dur_ns"] / 1e9
        obs.disable()
        (point,) = space.points()
        sa = backend.analyze(eng.analysis, point)
        selections = backend.select(eng.analysis, point, sa)
        est = price_sampled(sa, selections, spec)
        ss = sa.structural
        # a window whose partition holds no candidate places nothing
        n_placed = sum(1 for result, _ in selections if result.candidates)
        have = fixtures.sampled_summary(ss, est)
        have["record"] = res.records[0].to_dict()
        ref = want["synthetic"]["modes"][mode]
        differs = [k for k in ref if have.get(k) != ref[k]]
        n_measured = len(ss.measured_marks())
        summary["synthetic"][mode] = dict(
            seconds=secs, span_seconds=spans, skim_rate=ss.skim_rate,
            rows=have["rows"], marks=len(ss.marks), measured=n_measured,
            placed=n_placed, launches=got, differs=differs, metrics=est.metrics, ci=est.ci)
        print(f"  KM@256 {mode:10s} {have['rows']} rows in {len(ss.marks)} "
              f"marks ({n_measured} measured, {n_placed} with "
              f"candidates), {secs:.3f} s wall; spans "
              + json.dumps({k: round(v, 3) for k, v in spans.items()})
              + f"; skim {ss.skim_rate:,.0f} virtual instr/s; launches "
              + json.dumps(got) + "; "
              + ("== reference" if not differs else f"DIFFERS {differs}"),
              flush=True)
        if differs:
            failures.append(f"KM@256 {mode}: {differs} differ")
        if got != {"replay": 1, "place": n_placed}:
            failures.append(f"KM@256 {mode}: launches {got}, want one "
                            f"replay and {n_placed} placements (the "
                            f"measured windows with candidates)")

    # K1 on KM@256's windowed stream (stratified) against the plain
    # replay, then the device time of the sampled path's K1 and K4 launches
    spec = SamplingSpec(mode="stratified", **SYNTH_SPEC)
    backend = CimBackend(sampling=spec)
    eng = DSEEngine(device=dev, backend=backend)
    (point,) = SweepSpace(workloads=("KM@256",)).points()
    ss = backend.analyze(eng.analysis, point).structural
    ct = ss.trace("cpu")
    mem = torch.nonzero(ct.mem_mask).flatten()
    addrs, is_w = ct.addr[mem], ct.op[mem] == OP_STORE
    hier = CacheHierarchy(levels)
    t0 = time.perf_counter()
    plain = hier.replay(addrs, is_w)
    plain_ms = (time.perf_counter() - t0) * 1e3
    addrs_d, is_w_d = addrs.to(dev), is_w.to(dev)
    (got_k1,) = replay_columns_batch(addrs_d, is_w_d, [levels])
    torch.cuda.synchronize()
    k1_equal = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                   for a, b in zip(got_k1[:4], plain)) \
        and got_k1[4] == hier.counters()
    k1_ms = event_ms(lambda: replay_columns_batch(addrs_d, is_w_d,
                                                  [levels]), 5)
    l1_misses = hier.counters()[f"{levels[0].name}_misses"]
    k1_bound, k1_bound_by = bytes_bound_ms(
        addrs.numel() * (addrs.element_size() + is_w.element_size()
                         + sum(c.element_size() for c in got_k1[:4])), 0)
    print(f"  K1 on KM@256's windowed stream: {addrs.numel()} accesses, "
          f"{l1_misses} first-level misses, "
          f"{'== plain' if k1_equal else 'DIFFERS from plain'}; kernel "
          f"{k1_ms:.4f} ms (events), plain {plain_ms:.1f} ms (host), "
          f"bound {k1_bound:.6f} ms ({k1_bound_by})", flush=True)
    if not k1_equal:
        failures.append("K1 differs from CacheHierarchy.replay on KM@256's "
                        "windowed stream")

    events, _ = device_ms_by_kernel(
        lambda: select_sampled(attach_sampled(ss, levels, device=dev),
                               OffloadConfig()))
    device_ms = {}
    for name in MAIN_PATH_KERNELS:
        hits = [(ms, n) for key, (ms, n) in events.items()
                if f"{name}_kernel" in key]
        device_ms[name] = dict(device_ms=sum(ms for ms, _ in hits),
                               launches=sum(n for _, n in hits))
    print("  sampled path on the device (KM@256, stratified): "
          + json.dumps({k: {x: round(y, 4) for x, y in v.items()}
                        for k, v in device_ms.items()}), flush=True)
    summary.update(k1=dict(accesses=addrs.numel(), l1_misses=l1_misses,
                           equal=k1_equal, ms=k1_ms, plain_ms=plain_ms,
                           bound_ms=k1_bound, bound_by=k1_bound_by),
                   device_ms=device_ms, launches=launches,
                   failures=failures)
    return summary, launches


def _strict_json(records):
    """Reference records as the service sends them: non-finite floats
    become null (``records_json``)."""
    import math
    return [{k: (None if isinstance(v, float) and not math.isfinite(v)
                 else v) for k, v in r.items()} for r in records]


def _space_doc(space):
    """A sweep space of preset names as a request document (raises where
    an axis value has no name in the wire vocabulary)."""
    from repro_torch.dse import CACHE_PRESETS, HOST_PRESETS, LEVEL_PRESETS

    caches = [c.name for c in space.caches]
    hosts = [h.name for h in space.hosts if h is not None]
    if (any(c.name not in CACHE_PRESETS
            or CACHE_PRESETS[c.name] != c.levels for c in space.caches)
            or any(lv not in LEVEL_PRESETS for lv in space.cim_levels)
            or any(HOST_PRESETS.get(h.name) != h.model
                   for h in space.hosts if h is not None)
            or (hosts and len(hosts) != len(space.hosts))):
        raise ValueError("the space has a value the wire vocabulary cannot "
                         "name")
    doc = {"workloads": list(space.workloads), "caches": caches,
           "cim_levels": list(space.cim_levels),
           "techs": list(space.techs), "cim_sets": list(space.cim_sets)}
    if hosts:
        doc["hosts"] = hosts
    return doc


def _serve_subprocess(dev):
    """``python -m repro_torch.dse.service --port 0 --device cuda`` as a
    process of its own: one sweep, then SIGTERM.  Returns (record of the
    sweep, exit code, its output, seconds from start to exit)."""
    import queue
    import signal
    import threading
    from repro_torch.dse.service import ServiceClient

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.dse.service", "--port", "0",
         "--device", str(dev)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()

    def read():
        for ln in proc.stdout:
            lines.put(ln)
        lines.put(None)                      # the process closed its output

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    out, record = [], None
    try:
        while True:
            line = lines.get(timeout=120)
            if line is None:
                raise RuntimeError("the daemon process ended before "
                                   "serving: " + "".join(out)[-2000:])
            out.append(line)
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                break
        client = ServiceClient(m.group(1))
        client.wait_ready(60)
        (record,) = client.sweep(["NB"]).records
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    while not lines.empty():
        line = lines.get()
        if line is not None:
            out.append(line)
    return record, rc, "".join(out), time.perf_counter() - t0


def service_phase(dev, smi):
    """Phase 9: the port's DSE daemon on ``dev`` (``repro_torch.dse.
    service``): the service benchmark's storm, the fig14–17 spaces as
    ``/v1/sweep`` requests, fig_adaptive as an adaptive request, KM@256
    sampled, each held (==) to the reference's records; the replay and
    placement launches against the builds that caused them; a warm repeat
    that launches nothing; a daemon process stopped by SIGTERM; one
    request's Chrome trace and the storm's stage attribution.  Returns
    (summary for the detail file, the phase's replay/place launches)."""
    from repro_torch import obs
    from repro_torch.bench import run as bench_run
    from repro_torch.bench import service as bench_service
    from repro_torch.bench.sampling import SYNTH_SPEC
    from repro_torch.core import accel
    from repro_torch.core.sampling import SamplingSpec
    from repro_torch.dse import CimBackend, SweepSpace
    from repro_torch.dse.service import ServiceClient, running_server
    from repro_torch.workloads import fixtures

    failures, summary = [], {}
    ref_records = fixtures.reference_records()
    if obs.tracer() is not None:
        failures.append("a tracer was left installed before the service "
                        "phase; it would take the service's spans")

    def builds(cache):
        return dict(replay_batches=cache.replay_batches,
                    single_replays=cache.single_replays,
                    offload_builds=cache.offload_builds,
                    trace_builds=cache.trace_builds)

    def counted(cache, fn):
        """fn() with the launches and exact-path builds it caused."""
        b0, l0 = builds(cache), accel.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        b1, l1 = builds(cache), accel.launch_counts()
        return out, {k: l1[k] - l0[k] for k in MAIN_PATH_KERNELS}, \
            {k: b1[k] - b0[k] for k in b1}

    def check_launches(what, got, d):
        want = {"replay": d["replay_batches"] + d["single_replays"],
                "place": d["offload_builds"]}
        if got != want:
            failures.append(f"{what}: launches {got}, builds say {want}")

    accel.reset_launch_counts()
    t_phase = time.perf_counter()
    with running_server(max_workers=4, device=dev) as (url, svc):
        cache = svc.analysis_cache("cim")
        client = ServiceClient(url)

        # (a) the storm at the service benchmark's defaults
        storm, got, d = counted(cache, lambda: bench_service.run(
            url=url, service=svc, device=dev))
        pts, warm = storm["points"], storm["warm_repeat"]
        print(f"  storm: {storm['n_requests']} requests from "
              f"{storm['clients']} clients in {storm['storm_wall_s']:.3f} s "
              f"({storm['requests_per_s']:.3f} req/s), latency p50 "
              f"{storm['latency_s']['p50']:.4f} s p99 "
              f"{storm['latency_s']['p99']:.4f} s; points "
              + json.dumps(pts) + f", dedup {storm['dedup_ratio']}; "
              f"launches {json.dumps(storm['storm_launches'])}, builds "
              f"{json.dumps(storm['storm_builds'])}; kernels compiled / "
              f"loaded during the storm: "
              f"{json.dumps(storm['kernels_during_storm'])}; warm "
              f"repeat " + json.dumps(warm), flush=True)
        failures += [f"storm: {f}" for f in bench_service.check(storm)]
        if ((pts["requested"], pts["evaluated"], pts["unique_keys"])
                != (384, 36, 36) or storm["dedup_ratio"] != 10.667
                or warm["trace_builds"] or warm["evaluated"]
                or any(warm["launches"].values())
                or storm["tracing"].get("distinct_ids") != 16):
            failures.append(f"storm counts: {pts}, dedup "
                            f"{storm['dedup_ratio']}, warm {warm}, tracing "
                            f"{storm['tracing']}")
        check_launches("storm, probe and warm repeat", got, d)

        # one request's Chrome trace; the storm's stage attribution
        spans = svc.buffered_spans()
        ids = set(storm["tracing"]["trace_ids"])
        storm_spans = [s for s in spans if s["trace_id"] in ids]
        last = [s for s in spans
                if s["trace_id"] == storm["tracing"]["trace_ids"][-1]]
        path = ROOT / "chiprun_out" / "service_trace.json"
        n_x = obs.export_chrome(last, (), path)
        doc = json.loads(path.read_text())
        x_events = sum(e["ph"] == "X" for e in doc["traceEvents"])
        att = obs.stage_attribution(storm_spans)
        print(f"  Chrome trace of one storm request: {n_x} X events for "
              f"{len(last)} spans -> {path.relative_to(ROOT)}", flush=True)
        print("  storm stage attribution (16 requests):", flush=True)
        for line in obs.attribution_markdown(att).splitlines():
            print(f"    {line}", flush=True)
        if not (n_x == x_events == len(last) > 0):
            failures.append(f"Chrome export: {n_x} / {x_events} X events "
                            f"for {len(last)} spans")

        # (b) the fig14–17 spaces as /v1/sweep requests
        docs = {name: _space_doc(bench_run.ALL[name].space())
                for name in ("fig14", "fig15", "fig16", "fig17")}

        def sweeps():
            t0 = time.perf_counter()
            replies = {name: client.sweep(doc.pop("workloads"), **doc)
                       for name, doc in json.loads(json.dumps(docs)).items()}
            return replies, time.perf_counter() - t0

        (replies, sweep_s), sweep_got, sweep_d = counted(cache, sweeps)
        equal = {name: r.records == _strict_json(ref_records[name])
                 for name, r in replies.items()}
        print(f"  fig14-17 spaces: {sum(len(r.records) for r in replies.values())}"
              f" records in {sweep_s:.3f} s, == reference "
              + json.dumps(equal) + f"; launches {json.dumps(sweep_got)}, "
              f"builds {json.dumps(sweep_d)}", flush=True)
        if not all(equal.values()):
            failures.append(f"sweep records differ: {equal}")
        check_launches("fig14-17 sweeps", sweep_got, sweep_d)
        (again, again_s), again_got, _ = counted(cache, sweeps)
        print(f"  fig14-17 warm repeat: {again_s:.3f} s, launches "
              + json.dumps(again_got), flush=True)
        if any(again_got.values()) or any(
                a.records != replies[n].records for n, a in again.items()):
            failures.append(f"warm repeat of the sweeps launched "
                            f"{again_got} or differed")

        # (c) fig_adaptive: its fourth geometry (128K+2M) is no preset, so
        # the full space goes through the service's event stream in
        # process; the preset part of it goes over HTTP
        fa = bench_run.ALL["fig_adaptive"]
        req = {"backend": "cim", "mode": "adaptive", "space": fa.space(),
               "objectives": fa.OBJECTIVES, "max_rounds": 8,
               "sampling": SamplingSpec()}
        t0 = time.perf_counter()
        events, ad_got, ad_d = counted(
            cache, lambda: list(svc.run_request(req)))
        ad_s = time.perf_counter() - t0
        rounds = [{k: e[k] for k in ("round", "n_candidates", "n_priced",
                                     "frontier_size", "stable")}
                  for e in events if e["event"] == "round"]
        want = ref_records["adaptive"]
        result = events[-1]
        adaptive_equal = dict(
            rounds=rounds == want["rounds"],
            frontier=result["frontier"] == _strict_json(want["frontier"]),
            records=result["records"] == _strict_json(want["records"]))
        print(f"  fig_adaptive: {len(rounds)} rounds priced "
              f"{[r['n_priced'] for r in rounds]} in {ad_s:.3f} s, == "
              "reference " + json.dumps(adaptive_equal) + "; launches "
              + json.dumps(ad_got), flush=True)
        if not all(adaptive_equal.values()):
            failures.append(f"adaptive differs: {adaptive_equal}")
        check_launches("fig_adaptive", ad_got, ad_d)
        preset = fa.space()
        http_doc = _space_doc(SweepSpace(
            workloads=preset.workloads,
            caches=tuple(c.name for c in preset.caches
                         if c.name in ("32K+256K", "64K+256K", "64K+2M")),
            cim_levels=preset.cim_levels, techs=preset.techs,
            hosts=preset.hosts))
        ident = ("workload", "cache", "cim_levels", "tech", "cim_set", "host")
        exhaustive = {tuple(r[k] for k in ident): r
                      for r in _strict_json(ref_records["fig_adaptive"])}
        streamed, http_got, http_d = counted(cache, lambda: list(
            client.adaptive_events(http_doc.pop("workloads"),
                                   objectives=list(fa.OBJECTIVES),
                                   **http_doc)))
        http_rounds = [e for e in streamed if e["event"] == "round"]
        http_recs = streamed[-1]["records"]
        http_equal = all(
            dict(r, index=0, round=0)
            == dict(exhaustive[tuple(r[k] for k in ident)], index=0,
                    round=0) for r in http_recs)
        print(f"  fig_adaptive over HTTP (the three preset geometries): "
              f"{len(http_rounds)} round events, {len(http_recs)} records, "
              f"each == the reference's exhaustive record: {http_equal}; "
              f"launches {json.dumps(http_got)}", flush=True)
        if not (http_equal and http_rounds and http_recs):
            failures.append("adaptive over HTTP: records differ from the "
                            "reference's exhaustive sweep")
        check_launches("fig_adaptive over HTTP", http_got, http_d)

        # (d) KM@256 sampled, stratified, the sampling benchmark's spec
        spec = SamplingSpec(mode="stratified", **SYNTH_SPEC)
        t0 = time.perf_counter()
        sreply, s_got, _ = counted(cache, lambda: client.sweep(
            ["KM@256"], sampling=spec.to_dict()))
        s_s = time.perf_counter() - t0
        backend = CimBackend(sampling=spec)
        (point,) = SweepSpace(workloads=("KM@256",)).points()
        sa = backend.analyze(cache, point)
        n_placed = sum(1 for result, _ in backend.select(cache, point, sa)
                       if result.candidates)
        ref_rec = fixtures.reference_sampled()["synthetic"]["modes"][
            "stratified"]["record"]
        s_equal = sreply.records == _strict_json([ref_rec])
        print(f"  KM@256 sampled (stratified): {s_s:.3f} s, record == "
              f"reference: {s_equal}; launches {json.dumps(s_got)} (one "
              f"replay, {n_placed} windows with candidates)", flush=True)
        if not s_equal:
            failures.append("KM@256 sampled record differs")
        if s_got != {"replay": 1, "place": n_placed}:
            failures.append(f"KM@256 sampled: launches {s_got}, want one "
                            f"replay and {n_placed} placements")
        metrics = client.metrics()
    launches = {k: accel.launch_counts()[k] for k in MAIN_PATH_KERNELS}
    phase_s = time.perf_counter() - t_phase
    if obs.tracer() is not None:
        failures.append("the service left its tracer installed")

    # (f) a daemon process of its own, stopped by SIGTERM
    record, rc, out, proc_s = _serve_subprocess(dev)
    want_nb = next(r for r in ref_records["fig16"] if r["workload"] == "NB"
                   and r["tech"] == "sram")
    proc_ok = (rc == 0 and "[dse.service] clean shutdown" in out
               and record == dict(_strict_json([want_nb])[0], index=0))
    print(f"  daemon process: one sweep, SIGTERM, exit code {rc} after "
          f"{proc_s:.3f} s; record == reference: "
          f"{record == dict(_strict_json([want_nb])[0], index=0)}; "
          + " | ".join(ln for ln in out.splitlines()
                       if ln.startswith("[dse.service]")), flush=True)
    if not proc_ok:
        failures.append(f"daemon process: exit {rc}, output {out[-2000:]!r}")

    print(f"service phase: {phase_s:.3f} s wall in process on "
          f"{torch.cuda.get_device_name(0)}; launches "
          + json.dumps(launches) + "; storm "
          f"{storm['requests_per_s']:.3f} req/s, p50 "
          f"{storm['latency_s']['p50']:.4f} s, p99 "
          f"{storm['latency_s']['p99']:.4f} s", flush=True)
    print(smi, flush=True)
    if min(launches.values()) <= 0:
        failures.append(f"a kernel of the service path never launched: "
                        f"{launches}")
    summary.update(storm=storm, storm_attribution=att,
                   sweeps=dict(seconds=sweep_s, equal=equal,
                               launches=sweep_got, builds=sweep_d,
                               warm_seconds=again_s,
                               warm_launches=again_got),
                   adaptive=dict(seconds=ad_s, rounds=rounds,
                                 equal=adaptive_equal, launches=ad_got,
                                 http_rounds=len(http_rounds),
                                 http_records=len(http_recs),
                                 http_equal=http_equal),
                   sampled=dict(seconds=s_s, equal=s_equal,
                                launches=s_got, placed=n_placed),
                   process=dict(rc=rc, seconds=proc_s, output=out),
                   metrics=metrics, phase_s=phase_s, launches=launches,
                   failures=failures)
    return summary, launches


def _run_entry_point(argv, timeout=600):
    """Run one of the port's entry points in a process of its own on the
    card; returns (exit code, stdout, stderr, seconds, the launches its
    device line reports or None)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    m = re.search(r"replay kernel launches (\d+), placement kernel "
                  r"launches (\d+)", proc.stdout)
    launches = (dict(replay=int(m.group(1)), place=int(m.group(2)))
                if m else None)
    return proc.returncode, proc.stdout, proc.stderr, secs, launches


def entry_points_phase(dev, traces, smi):
    """Phase 10: the CiM entry points on ``dev``.  The single-pass
    Algorithm 1 (both placement-dependent configs) on the 17 VM traces at
    32K+256K against the committed reference records, with its selection
    seconds beside the two-phase path's on the same traces; the quickstart
    and evaluate_workloads examples, each in a process of its own, against
    the reference examples' lines; the dse_cim example twice on one
    store; ``python -m repro_torch.bench timing --workloads NB``.  Returns
    (summary for the detail file, the phase's replay/place launches)."""
    from repro_torch.core import accel
    from repro_torch.core.offload import OffloadConfig, select_candidates
    from repro_torch.core.profiler import profile_system
    from repro_torch.core.reshape import reshape
    from repro_torch.core.trace import attach_cache_results
    from repro_torch.workloads import fixtures

    failures = []
    ref = fixtures.reference_single_pass()
    want = {(r["workload"], r["config"], r["tech"]): r
            for r in ref["records"]}
    levels = fixtures.CACHES[fixtures.SINGLE_PASS_CACHE]

    # (a) single pass: each selection on a fresh copy of the VM trace, so
    # it builds its own IDG and flow tables, as the two-phase timing does
    t_phase = time.perf_counter()
    l0 = accel.launch_counts()
    select_s = dict.fromkeys((*fixtures.SINGLE_PASS_CONFIGS, "two_phase"),
                             0.0)
    two_phase_k4 = 0
    n_equal = 0
    got_records = []
    for name in fixtures.WORKLOADS:
        for config, kw in (*fixtures.SINGLE_PASS_CONFIGS.items(),
                           ("two_phase", {})):
            tr = attach_cache_results(fresh(traces[name]), levels,
                                      device=dev)
            cfg = OffloadConfig(**kw)
            k4 = accel.launch_counts()["place"]
            t0 = time.perf_counter()
            res = select_candidates(tr.trace, cfg=cfg, device=dev)
            torch.cuda.synchronize()
            select_s[config] += time.perf_counter() - t0
            placed = accel.launch_counts()["place"] - k4
            if config == "two_phase":
                two_phase_k4 += placed
                continue
            if placed:
                failures.append(f"{name}/{config}: the single pass "
                                f"launched placement {placed} times")
            shaped = reshape(tr.trace, res)
            reports = {tech: profile_system(tr, cfg, tech, offload=res,
                                            reshaped=shaped, device=dev)
                       for tech in fixtures.TECHS}
            for rec in fixtures.single_pass_records(name, config, res,
                                                    reports):
                got_records.append(rec)
                if rec == want.get((name, config, rec["tech"])):
                    n_equal += 1
                else:
                    failures.append(f"single pass {name}/{config}/"
                                    f"{rec['tech']}: {rec}")
    l1 = accel.launch_counts()
    sp_launches = {k: l1[k] - l0[k] for k in MAIN_PATH_KERNELS}
    phase_launches = dict(sp_launches)
    sp_s = time.perf_counter() - t_phase
    print(f"single pass: {len(got_records)} records, {n_equal} of "
          f"{len(ref['records'])} == the reference; selection seconds "
          + json.dumps({k: round(v, 3) for k, v in select_s.items()})
          + f" (17 workloads each, 32K+256K, tables and flow built in "
          f"each); launches {json.dumps(sp_launches)} (place only in the "
          f"two-phase comparison: {two_phase_k4}); {sp_s:.3f} s", flush=True)
    if len(got_records) != len(ref["records"]) or \
            n_equal != len(ref["records"]):
        failures.append(f"single pass: {n_equal} of {len(got_records)} "
                        f"equal, {len(ref['records'])} in the fixture")
    if sp_launches["replay"] <= 0:
        failures.append("single pass: the replay kernel never launched")

    # (b) the examples, each in a process of its own on the card
    examples = {}
    for key, argv, want_lines in (
            ("quickstart", ["examples/torch_quickstart.py"],
             ref["examples"]["quickstart"]),
            *((f"evaluate_workloads_{tech}",
               ["examples/torch_evaluate_workloads.py", "--tech", tech],
               ref["examples"]["evaluate_workloads"][tech])
              for tech in fixtures.TECHS)):
        rc, out, err, secs, launches = _run_entry_point(argv)
        same = rc == 0 and fixtures.example_lines(out) == want_lines
        examples[key] = dict(rc=rc, seconds=secs, equal=same,
                             launches=launches)
        print(f"  {key:26s} exit {rc}, {secs:7.3f} s, lines == reference: "
              f"{same}, launches {json.dumps(launches)}", flush=True)
        if not same:
            failures.append(f"{key}: exit {rc}, output {out[-1500:]!r} "
                            f"{err[-1500:]!r}")
        if not launches or min(launches.values()) <= 0:
            failures.append(f"{key}: launches {launches}")
        for k in MAIN_PATH_KERNELS:
            phase_launches[k] += (launches or {}).get(k, 0)

    # (c) the dse_cim example twice on one store: the second run traces
    # nothing and launches nothing
    store_runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_store_") as d:
        for _ in range(2):
            rc, out, err, secs, launches = _run_entry_point(
                ["examples/torch_dse_cim.py", "--workload", "KM",
                 "--cache-dir", d])
            m = re.search(r"trace builds (\d+), selection builds (\d+)",
                          out)
            builds = (int(m.group(1)), int(m.group(2))) if m else None
            store_runs.append(dict(rc=rc, seconds=secs, builds=builds,
                                   launches=launches))
            print(f"  dse_cim --workload KM --cache-dir: exit {rc}, "
                  f"{secs:7.3f} s, (trace, selection) builds {builds}, "
                  f"launches {json.dumps(launches)}", flush=True)
            for k in MAIN_PATH_KERNELS:
                phase_launches[k] += (launches or {}).get(k, 0)
            if rc != 0:
                failures.append(f"dse_cim: exit {rc} {err[-1500:]!r}")
    first, second = store_runs
    if (first["builds"] is None or first["builds"][0] <= 0
            or not first["launches"] or min(first["launches"].values()) <= 0
            or second["builds"] != (0, 0)
            or second["launches"] != dict(replay=0, place=0)):
        failures.append(f"dse_cim store runs: {store_runs}")

    # (d) the timing driver
    with tempfile.TemporaryDirectory(prefix="chip_smoke_timing_") as d:
        doc_path = pathlib.Path(d) / "timing.json"
        rc, out, err, secs, _ = _run_entry_point(
            ["-m", "repro_torch.bench", "timing", "--workloads", "NB",
             "--json", str(doc_path)])
        doc = json.loads(doc_path.read_text()) if rc == 0 else None
    print(f"  bench timing --workloads NB: exit {rc}, {secs:7.3f} s; doc "
          + json.dumps(doc), flush=True)
    if doc is None:
        failures.append(f"bench timing: exit {rc} {err[-1500:]!r}")
    else:
        for k in MAIN_PATH_KERNELS:
            phase_launches[k] += doc["launches"][k]
        if min(doc["launches"].values()) <= 0 or doc["card"] != smi:
            failures.append(f"bench timing: launches {doc['launches']}, "
                            f"card {doc['card']!r}")
    phase_s = time.perf_counter() - t_phase
    print(f"entry points: {phase_s:.3f} s on {torch.cuda.get_device_name(0)}"
          f"; launches " + json.dumps(phase_launches), flush=True)
    return dict(single_pass=dict(records=len(got_records), equal=n_equal,
                                 select_s=select_s, launches=sp_launches,
                                 two_phase_place=two_phase_k4,
                                 seconds=sp_s),
                examples=examples, store_runs=store_runs, timing=doc,
                phase_s=phase_s, launches=phase_launches,
                failures=failures), phase_launches



def decode_bytes_bound(cfg, batch, prompt_len, gen):
    """The least bytes one timed decode step of ``launch.serve`` must move,
    averaged over its steps: every parameter read once (the tied embedding
    is the head), the keys and values each layer's mask keeps (window or
    all positions so far; bf16 cache), and the bf16 logits written.
    Returns (bytes, its parts)."""
    import math as _math
    from repro_torch.models.transformer import layer_windows, param_layout

    def leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)
        else:
            yield node
    params = sum(_math.prod(leaf.shape) * torch.empty(
        (), dtype=leaf.torch_dtype).element_size()
        for leaf in leaves(param_layout(cfg)))
    row = batch * cfg.n_kv_heads * cfg.head_dim * 2 * 2      # k and v, bf16
    positions = range(prompt_len, prompt_len + gen - 1)
    kv = sum(sum(min(p + 1, int(w)) if w else p + 1
                 for w in layer_windows(cfg))
             * row for p in positions) / len(positions)
    logits = batch * cfg.padded_vocab * 2
    return params + kv + logits, dict(param_bytes=params, kv_bytes=kv,
                                      logits_bytes=logits)


def serve_phase(dev, smi):
    """Phase 11: the model zoo's serving path on ``dev``.  (a) Each case of
    ``repro_torch.models.fixtures.serve_cases`` -- the ten reduced archs
    and gemma3-1b at its published widths cut to 6 layers, f32 -- run
    greedily on the card from ``numpy_params`` and held to the reference's
    ``reference_serve.json``: tokens ==, logits within ``LOGITS_TOL``.  (b)
    ``python -m repro_torch.launch.serve --arch gemma3-1b --preset full``
    (26 layers, bf16) as a process of its own, B=4 with prompts of 64 and
    1024 tokens and 32 generated, beside the decode step's bytes bound.
    Returns the summary for the detail file (``failures`` lists misses)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import convert, fixtures

    from repro_torch import kernels as cim_kernels
    from repro_torch.core import accel

    t_phase = time.perf_counter()
    failures = []
    doc = fixtures.load()
    # the serving path, like the reference's model path, has no kernel of
    # its own and calls none of K1-K8: the counts stay 0 over the phase
    accel.reset_launch_counts()
    cim_kernels.reset_launch_counts()
    print(f"serve: f32 products on the card with TF32 "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        failures.append("TF32 matmuls are on: the f32 comparison needs "
                        "them off")
    cases = {}
    for case in fixtures.serve_cases():
        t0 = time.perf_counter()
        params = convert.from_reference(
            case.cfg, convert.numpy_params(case.cfg, fixtures.SEED_PARAMS),
            device=dev)
        t1 = time.perf_counter()
        tokens, logits = fixtures.greedy_run(params, case, device=dev)
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t1
        res = fixtures.compare(doc["cases"][case.name], tokens, logits)
        res.update(load_s=t1 - t0, run_s=run_s, tokens=tokens.tolist())
        cases[case.name] = res
        print(f"  {case.name:24s} tokens == {res['tokens_equal']}, logits "
              f"max |err| {res['max_abs_err']:.3g} "
              f"({res['share_of_tol']:.4f} of {fixtures.LOGITS_TOL}); "
              f"weights {t1 - t0:.3f} s, prefill + {case.steps} steps "
              f"{run_s:.3f} s", flush=True)
        if not res["ok"]:
            failures.append(f"serve fixture {case.name}: {res}")
        del params
        torch.cuda.empty_cache()

    cfg = get_config("gemma3-1b")
    runs = []
    for prompt_len in (64, 1024):
        batch, gen = 4, 32
        argv = ["-m", "repro_torch.launch.serve", "--arch", "gemma3-1b",
                "--preset", "full", "--batch", str(batch), "--prompt-len",
                str(prompt_len), "--gen", str(gen)]
        rc, out, err, secs, _ = _run_entry_point(argv)
        lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
        timing = next((json.loads(ln) for ln in out.splitlines()
                       if ln.startswith("{")), None)
        if rc != 0 or len(lines) != 2 or timing is None \
                or timing["device"] != torch.cuda.get_device_name(0):
            failures.append(f"serve B={batch} prompt={prompt_len}: exit "
                            f"{rc} {out[-1500:]!r} {err[-1500:]!r}")
            continue
        n_bytes, parts = decode_bytes_bound(cfg, batch, prompt_len, gen)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        step_ms = timing["decode_s"] / timing["decode_steps"] * 1e3
        run = dict(batch=batch, prompt_len=prompt_len, gen=gen,
                   prefill_ms=timing["prefill_s"] * 1e3,
                   decode_ms_per_step=step_ms,
                   tokens_per_s=timing["tokens_per_s"],
                   decode_bound_ms=bound_ms, bound_share=bound_ms / step_ms,
                   param_count=cfg.param_count(), process_s=secs,
                   lines=lines, **parts)
        runs.append(run)
        print(f"  serve gemma3-1b full bf16 B={batch} prompt={prompt_len} "
              f"gen={gen}: prefill {run['prefill_ms']:.3f} ms, decode "
              f"{step_ms:.4f} ms a step ({run['tokens_per_s']:.2f} tok/s); "
              f"decode bytes bound {bound_ms:.4f} ms (parameters "
              f"{parts['param_bytes'] / 1e9:.4f} GB for param_count() = "
              f"{cfg.param_count():,}, KV {parts['kv_bytes'] / 1e6:.3f} MB "
              f"a step, logits {parts['logits_bytes'] / 1e6:.3f} MB, at "
              f"3.35 TB/s): the step at {run['bound_share']:.4f} of it; "
              f"{secs:.1f} s for the process", flush=True)
        print("   " + " / ".join(lines), flush=True)
    # (c) where a decode step's time goes: the first run's model and step
    # in this process, traced by torch.profiler
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import inputs as minputs
    from repro_torch.models.transformer import init_params
    from repro_torch.train import steps as steps_mod
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(gen, cfg, device=dev)
        batch = minputs.make_train_batch(gen, cfg, 4, 64, device=dev)
        batch.pop("labels")
        tok, cache = steps_mod.make_prefill_step(cfg, 96)(params, batch)
        decode = steps_mod.make_decode_step(cfg)

        def step():
            decode(params, tok, cache, 64)
        names = {}
        device_ms, kernels = profiled_device_ms(step, 10, names)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 10
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step()
            torch.cuda.synchronize()
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        top_ops = {e.key: [round(e.self_cpu_time_total / 1e3, 4), e.count]
                   for e in ops[:8]}
        del params, cache
        torch.cuda.empty_cache()
    profile_doc = dict(step_ms=step_ms, device_ms=device_ms,
                       kernels_per_step=kernels,
                       idle_share=(None if device_ms is None
                                   else 1 - device_ms / step_ms),
                       top_host_ops_ms_count=top_ops)
    print(f"  decode step (B=4, position 64) in process: {step_ms:.4f} ms "
          f"wall, device busy {device_ms} ms in {kernels} kernels, idle "
          f"share {profile_doc['idle_share']}; host self ms by op "
          + json.dumps(top_ops), flush=True)
    if device_ms is None:
        failures.append("serve: the profiled decode step ran nothing on "
                        "the device")

    launches = {**accel.launch_counts(), **cim_kernels.launch_counts()}
    print("  kernel launches in process over the phase (none expected): "
          + json.dumps(launches), flush=True)
    if any(launches.values()):
        failures.append(f"serve: kernels launched on the serving path: "
                        f"{launches}")
    phase_s = time.perf_counter() - t_phase
    print(f"serve: {phase_s:.3f} s on {torch.cuda.get_device_name(0)} "
          f"({smi})", flush=True)
    return dict(cases=cases, runs=runs, decode_profile=profile_doc,
                launches=launches, phase_s=phase_s, failures=failures)


def train_phase(dev, smi):
    """Phase 12: the model zoo's training path on ``dev``.  (a) Each case
    of ``repro_torch.train.fixtures.train_cases`` -- the ten reduced archs,
    qwen1.5-0.5b with two microbatches and int8 error feedback and with
    remat "block", gemma3-1b at its published widths cut to 6 layers,
    f32 -- trained on the card from ``numpy_params`` and held to the
    reference's ``reference_train.json``.  (b) ``python -m
    repro_torch.launch.train --arch gemma3-1b --preset full`` (26 layers,
    bf16), B=4, S=1024, 8 steps, remat "block", as a process of its own:
    step ms, tokens/s, peak memory, FLOPs and their share of the bf16
    peak, the final snapshot's bytes and seconds.  (c)
    ``examples/torch_train_resume.py``: one recovered failure, then a
    fresh process resuming from the last snapshot.  (d) The reference's
    learnable-data check.  (e) One full-width step in process under
    ``torch.profiler``.  Returns the summary for the detail file
    (``failures`` lists misses)."""
    import math as _math
    import shutil
    import statistics

    from repro_torch import kernels as cim_kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core import accel
    from repro_torch.models import convert
    from repro_torch.train import fixtures as train_fixtures
    from repro_torch.train import steps as steps_mod

    t_phase = time.perf_counter()
    failures = []
    doc = train_fixtures.load()
    # training, like serving, has no kernel of its own and calls none of
    # K1-K8: the counts stay 0 over the phase
    accel.reset_launch_counts()
    cim_kernels.reset_launch_counts()
    print(f"train: f32 products on the card with TF32 "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        failures.append("TF32 matmuls are on: the f32 comparison needs "
                        "them off")
    cases = {}
    for case in train_fixtures.train_cases():
        t0 = time.perf_counter()
        params = convert.from_reference(
            case.cfg, convert.numpy_params(case.cfg,
                                           train_fixtures.SEED_PARAMS),
            device=dev)
        t1 = time.perf_counter()
        metrics, final = train_fixtures.train_run(params, case, device=dev)
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t1
        res = train_fixtures.compare(doc["cases"][case.name], metrics, final)
        res.update(load_s=t1 - t0, run_s=run_s)
        cases[case.name] = res
        print(f"  {case.name:26s} metrics at {res['metric_share_of_tol']:.4f}"
              f" of their bound, parameters max |err| "
              f"{res['param_max_abs_err']:.3g} ({res['param_max_abs_err'] / res['param_tol']:.4f}"
              f" of {res['param_tol']:.3g}); losses "
              f"{[round(x, 6) for x in res['losses']]}; weights "
              f"{t1 - t0:.3f} s, {case.steps} steps {run_s:.3f} s",
              flush=True)
        if not res["ok"]:
            failures.append(f"train fixture {case.name}: {res}")
        del params, final
        torch.cuda.empty_cache()

    # (b) full width, bf16, as a user runs it
    cfg = get_config("gemma3-1b")
    B, S, steps = 4, 1024, 8
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_")
    full = None
    try:
        argv = ["-m", "repro_torch.launch.train", "--arch", "gemma3-1b",
                "--preset", "full", "--batch", str(B), "--seq-len", str(S),
                "--steps", str(steps), "--remat", "block", "--save-every",
                "0", "--ckpt-dir", ckpt_dir]
        rc, out, err, secs, _ = _run_entry_point(argv)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    lines = [ln for ln in out.splitlines() if ln.startswith("[train]")]
    timing = next((json.loads(ln) for ln in out.splitlines()
                   if ln.startswith("{")), None)
    if rc != 0 or timing is None or len(lines) < 2 \
            or timing["device"] != torch.cuda.get_device_name(0):
        failures.append(f"train gemma3-1b full: exit {rc} {out[-1500:]!r} "
                        f"{err[-1500:]!r}")
    else:
        fm = timing["final_metrics"]
        median = statistics.median(timing["step_ms"][1:])
        flops = timing["flops_per_step"]
        share = flops / BF16_OPS_PER_S / (median / 1e3)
        full = dict(batch=B, seq_len=S, steps=steps, remat="block",
                    step_ms=timing["step_ms"], median_step_ms=median,
                    tokens_per_s=B * S / (median / 1e3),
                    peak_memory_bytes=timing["peak_memory_bytes"],
                    flops_per_step=flops,
                    flops_bound_ms=flops / BF16_OPS_PER_S * 1e3,
                    bf16_peak_share=share, ckpt_bytes=timing["ckpt_bytes"],
                    ckpt_s=timing["ckpt_s"], final_metrics=fm,
                    param_count=cfg.param_count(), process_s=secs,
                    lines=lines)
        print(f"  train gemma3-1b full bf16 B={B} S={S} remat block, "
              f"{steps} steps: median step {median:.3f} ms over steps 2-"
              f"{steps} ({full['tokens_per_s']:.1f} tokens/s); first step "
              f"{timing['step_ms'][0]:.3f} ms; peak memory "
              f"{timing['peak_memory_bytes'] / 2 ** 30:.3f} GiB; "
              f"{flops / 1e12:.4f} TFLOP a step (6 x {cfg.param_count():,}"
              f" parameters x {B * S} tokens + the live attention scores), "
              f"{full['flops_bound_ms']:.3f} ms at 989 TFLOP/s: the step "
              f"at {share:.4f} of the bf16 peak; final snapshot "
              f"{timing['ckpt_bytes'] / 1e9:.3f} GB in "
              f"{timing['ckpt_s']:.3f} s; last loss {fm['loss']:.4f}, "
              f"grad_norm {fm['grad_norm']:.4f}; {secs:.1f} s for the "
              f"process", flush=True)
        print("   " + " / ".join(lines), flush=True)
        if not all(_math.isfinite(fm[k]) for k in ("loss", "grad_norm")):
            failures.append(f"train gemma3-1b full: non-finite {fm}")

    # (c) recovery: the resume example, each run on the card
    rc, out, err, secs, _ = _run_entry_point(
        [str(ROOT / "examples" / "torch_train_resume.py")])
    done = [ln for ln in out.splitlines() if ln.startswith("[train] done")]
    resume = dict(rc=rc, process_s=secs, done=done)
    print(f"  resume example: exit {rc} in {secs:.1f} s; " + " / ".join(
        ln[:120] for ln in done), flush=True)
    if rc != 0 or len(done) != 2 or "recoveries=1" not in done[0] \
            or "resumed_from=29" not in done[1]:
        failures.append(f"resume example: exit {rc} {out[-1500:]!r} "
                        f"{err[-1500:]!r}")

    # (d) the reference's learnable-data check
    qcfg = reduced_config("qwen1.5-0.5b")
    state = steps_mod.init_train_state(
        torch.Generator(device=dev).manual_seed(0), qcfg, device=dev)
    step = steps_mod.make_train_step(qcfg, TrainConfig(
        learning_rate=3e-3, total_steps=40, warmup_steps=4))
    toks = (torch.arange(32, dtype=torch.int32, device=dev)[None]
            .repeat(4, 1) % qcfg.vocab_size)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    losses = []
    t0 = time.perf_counter()
    for _ in range(40):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    learn = dict(first=losses[0], last=losses[-1],
                 ok=losses[-1] < 0.7 * losses[0],
                 seconds=time.perf_counter() - t0)
    print(f"  learnable data (qwen1.5-0.5b reduced, 40 steps): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} ({losses[-1] / losses[0]:.4f}"
          f" of the first; bound 0.7), {learn['seconds']:.2f} s", flush=True)
    if not learn["ok"]:
        failures.append(f"learnable data: {learn}")
    del state

    # (e) where a full-width step's time goes: in this process, traced
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_train_state(gen, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           dtype=torch.int32, device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = steps_mod.make_train_step(cfg, TrainConfig(
        total_steps=steps, warmup_steps=1, remat="block"))

    def one():
        step(state, batch)
    device_ms, kernels = profiled_device_ms(one, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 2
    # one more step traced: the device time of each kernel
    events, _ = device_ms_by_kernel(one)
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:10]
    profile_doc = dict(step_ms=step_ms, device_ms=device_ms,
                       kernels_per_step=kernels,
                       idle_share=(None if device_ms is None
                                   else 1 - device_ms / step_ms),
                       top_device_ms_count={k: list(v) for k, v in top})
    print(f"  train step (gemma3-1b full, bf16, B={B}, S={S}, remat block) "
          f"in process: {step_ms:.3f} ms wall, device busy {device_ms} ms "
          f"in {kernels} kernels, idle share {profile_doc['idle_share']}; "
          f"largest device events (ms, count): " + json.dumps(
              {k[:70]: [round(v[0], 3), v[1]] for k, v in top}), flush=True)
    if device_ms is None:
        failures.append("train: the profiled step ran nothing on the device")
    del state, batch
    torch.cuda.empty_cache()

    launches = {**accel.launch_counts(), **cim_kernels.launch_counts()}
    print("  kernel launches in process over the phase (none expected): "
          + json.dumps(launches), flush=True)
    if any(launches.values()):
        failures.append(f"train: kernels launched on the training path: "
                        f"{launches}")
    phase_s = time.perf_counter() - t_phase
    print(f"train: {phase_s:.3f} s on {torch.cuda.get_device_name(0)} "
          f"({smi})", flush=True)
    return dict(cases=cases, full=full, resume=resume, learnable=learn,
                step_profile=profile_doc, launches=launches,
                phase_s=phase_s, failures=failures)


def tpu_dse_phase(dev, smi):
    """Phase 13: the accelerator-mode DSE backend on ``dev``.  (a)
    fig_tpu_dse's grid with layer 1 recorded on the card, one analysis per
    workload, a warm second engine on the same store; each workload's
    analysis timed on its own first; the backward in the recorded graph.
    (b) The grid priced from the reference's analyses, == the fixture.
    (c) gemma3-1b at its published widths, bf16, B=4, S=1024: the
    analysis, its FLOPs held to ``FlopCounterMode``, seconds and peak
    memory.  (d) One ``"backend": "tpu"`` request through ``DSEService``.
    (e) ``examples/torch_dse_cim.py --backend tpu`` as a process.  (f) No
    K1-K8 launch.  Returns the summary for the detail file (``failures``
    lists misses)."""
    import shutil
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels as cim_kernels
    from repro_torch.bench import fig_tpu_dse
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core import accel
    from repro_torch.core.hlo import record_graph
    from repro_torch.core.hlo_cost import analyze_graph
    from repro_torch.dse import (DSEEngine, SweepSpace, TPU_PRESETS,
                                 TpuBackend, TpuOption)
    from repro_torch.dse import fixtures as tpu_fixtures
    from repro_torch.dse.backends import analyze_train_step, record_train_step
    from repro_torch.dse.service import DSEService
    from repro_torch.models import inputs as minputs
    from repro_torch.optim.tree import leaves
    from repro_torch.train import steps as steps_mod

    t_phase = time.perf_counter()
    failures = []
    accel.reset_launch_counts()
    cim_kernels.reset_launch_counts()

    def summary(an, secs):
        saved = sum(c.saved_bytes for c in an.candidates)
        return dict(eqns=an.n_eqns, candidates=len(an.candidates),
                    total_bytes=an.total_bytes, saved_bytes=saved,
                    tpu_macr=saved / an.total_bytes, flops=an.flops,
                    hlo_bytes=an.hlo_bytes, seconds=secs)

    # (a) each workload's layer 1 on the card, timed on its own
    per_workload, solo = {}, {}
    for w in fig_tpu_dse.WORKLOADS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        an = analyze_train_step(reduced_config(w), 2, 32, dev)
        torch.cuda.synchronize()
        solo[w] = an
        per_workload[w] = summary(an, time.perf_counter() - t0)
        print(f"  tpu analysis {w:14s} (reduced, B=2, S=32): "
              f"{an.n_eqns} eqns, {len(an.candidates)} candidates, "
              f"TPU-MACR {per_workload[w]['tpu_macr']:.4f}, "
              f"{an.flops:.0f} FLOPs, {per_workload[w]['seconds']:.3f} s",
              flush=True)
    # the backward runs on autograd's device thread: the recorder must see
    # it, so the step holds more than 3x the forward's products and FLOPs
    cfg = reduced_config("qwen1.5-0.5b")
    full_graph = record_train_step(cfg, 2, 32, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_train_state(gen, cfg, device=dev)
    batch = minputs.make_train_batch(gen, cfg, 2, 32, device=dev)
    with torch.no_grad():
        fwd_graph, _ = record_graph(steps_mod.loss_fn, state["params"], cfg,
                                    batch)
    n_mm = [sum(e.prim == "dot_general" for e in g.eqns)
            for g in (full_graph, fwd_graph)]
    fl = [analyze_graph(g).flops for g in (full_graph, fwd_graph)]
    backward = dict(step_products=n_mm[0], forward_products=n_mm[1],
                    step_flops=fl[0], forward_flops=fl[1])
    print(f"  recorded backward (qwen1.5-0.5b reduced): step {n_mm[0]} "
          f"products / {fl[0]:.0f} FLOPs, forward {n_mm[1]} / "
          f"{fl[1]:.0f}", flush=True)
    if not (n_mm[0] > 3 * n_mm[1] > 0 and fl[0] > 3 * fl[1]):
        failures.append(f"tpu: the recorded step misses its backward "
                        f"{backward}")
    del state, batch, full_graph, fwd_graph

    store = tempfile.mkdtemp(prefix="chip_smoke_tpu_store_")
    try:
        eng = DSEEngine(backend=TpuBackend(), store=store, device=dev)
        t0 = time.perf_counter()
        rows, results = fig_tpu_dse.run(engine=eng)
        grid_s = time.perf_counter() - t0
        st = results.stats
        grid = dict(points=len(results), seconds=grid_s,
                    analyses=st["trace_builds"],
                    selections=st["offload_builds"],
                    pareto=[(r["workload"], r["chip"], r["threshold"])
                            for r in rows if r["pareto"]])
        print(f"  fig_tpu_dse grid on the card: {len(results)} points in "
              f"{grid_s:.3f} s, {st['trace_builds']} analyses, "
              f"{st['offload_builds']} selections; front "
              + json.dumps(grid["pareto"]), flush=True)
        if (len(results), st["trace_builds"], st["offload_builds"]) != \
                (36, 4, 12):
            failures.append(f"tpu grid: {len(results)} points, "
                            f"{st['trace_builds']} analyses, "
                            f"{st['offload_builds']} selections")
        for w in fig_tpu_dse.WORKLOADS:
            got = eng.analysis._blobs[(1, "tpu", w, 2, 32)]
            if got != solo[w]:
                failures.append(f"tpu {w}: the grid's analysis differs "
                                f"from the same step recorded alone")
        warm = DSEEngine(backend=TpuBackend(), store=store, device=dev)
        t0 = time.perf_counter()
        again = warm.run(fig_tpu_dse.space())
        grid["warm_seconds"] = time.perf_counter() - t0
        grid["warm_analyses"] = again.stats["trace_builds"]
        grid["warm_store_hits"] = again.stats.get("store_l1_hits", 0)
        print(f"  warm engine on the same store: "
              f"{again.stats['trace_builds']} analyses, "
              f"{grid['warm_store_hits']} store hits, "
              f"{grid['warm_seconds']:.3f} s", flush=True)
        if again.stats["trace_builds"] != 0 or \
                [r.to_dict() for r in again] != \
                [r.to_dict() for r in results]:
            failures.append(f"tpu warm store: {again.stats}")
    finally:
        shutil.rmtree(store, ignore_errors=True)

    # (b) layers 2 and 3 on the reference's analyses
    doc = tpu_fixtures.load()
    recorded = DSEEngine(backend=tpu_fixtures.RecordedTpuBackend(),
                         device=dev)
    ref_grid = recorded.run(fig_tpu_dse.space())
    e2e = recorded.run(tpu_fixtures.end_to_end_space())
    same = dict(
        records=[r.to_dict() for r in ref_grid] == doc["grid"]["records"],
        pareto=[r.to_dict() for r in ref_grid.pareto(
            fig_tpu_dse.OBJECTIVES)] == doc["grid"]["pareto"],
        end_to_end=[r.to_dict() for r in e2e] == doc["end_to_end"])
    print(f"  the reference's analyses through the port's selection and "
          f"pricing: {len(ref_grid)} records, front of "
          f"{len(doc['grid']['pareto'])}, {len(e2e)} end-to-end records; "
          f"== the reference's: " + json.dumps(same), flush=True)
    if not all(same.values()):
        failures.append(f"tpu: records on the reference's analyses differ "
                        f"{same}")

    # (c) gemma3-1b at its published widths, the step phase 12 trains
    full_cfg = get_config("gemma3-1b")
    B, S = 4, 1024
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    an = analyze_train_step(full_cfg, B, S, dev)
    torch.cuda.synchronize()
    full = summary(an, time.perf_counter() - t0)
    full["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev) \
        - base_mem
    with FlopCounterMode(display=False) as fc:
        twice = analyze_train_step(full_cfg, B, S, dev)
    full["flop_counter"] = fc.get_total_flops()
    # a plain step on the same inputs, neither mode on: the recorder's cost
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_train_state(gen, full_cfg, device=dev)
    with torch.no_grad():
        for t in leaves(state):
            t.zero_()
    batch = minputs.make_train_batch(gen, full_cfg, B, S, device=dev)
    step = steps_mod.make_train_step(full_cfg, TrainConfig())
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    full["plain_step_s"] = time.perf_counter() - t0
    del state, batch
    torch.cuda.empty_cache()
    analytic = 6.0 * full_cfg.param_count() * B * S
    full["analytic_6nd"] = analytic
    print(f"  gemma3-1b full (26 layers, d 1152, vocab 262,144), bf16, "
          f"B={B}, S={S}, remat block, recorded on the card: "
          f"{an.n_eqns} eqns, {len(an.candidates)} candidates, "
          f"total {an.total_bytes} bytes, saved {full['saved_bytes']}, "
          f"TPU-MACR {full['tpu_macr']:.4f}, {an.flops / 1e12:.4f} TFLOP "
          f"(FlopCounterMode {fc.get_total_flops() / 1e12:.4f}; 6ND "
          f"{analytic / 1e12:.4f}, ratio {an.flops / analytic:.4f}), "
          f"recorder {full['seconds']:.3f} s vs a plain step "
          f"{full['plain_step_s']:.3f} s, peak memory "
          f"{full['peak_memory_bytes'] / 2 ** 30:.3f} GiB", flush=True)
    if an.flops != fc.get_total_flops() or not an.flops > 0:
        failures.append(f"tpu gemma3-1b full: {an.flops} FLOPs, "
                        f"FlopCounterMode {fc.get_total_flops()}")
    if twice != an:
        failures.append("tpu gemma3-1b full: two recordings differ")

    # (d) the service: one "backend": "tpu" request in process
    request = {"backend": "tpu", "workloads": ["xlstm-125m"],
               "tpus": ["v5e", {"chip": "v4", "min_saved_bytes": "16K"},
                        {"chip": "v5p", "min_saved_bytes": "1M",
                         "vmem_scale": 0.5}]}
    svc = DSEService(device=dev, tracing=False)
    t0 = time.perf_counter()
    events = list(svc.handle_query(request))
    service_s = time.perf_counter() - t0
    space = SweepSpace(workloads=("xlstm-125m",), tpus=tuple(
        TpuOption(TPU_PRESETS[c], t, v)
        for c, t, v in (("v5e", 1 << 16, 1.0), ("v4", 1 << 14, 1.0),
                        ("v5p", 1 << 20, 0.5))))
    want = [r.to_dict() for r in DSEEngine(backend=TpuBackend(),
                                           device=dev).run(space)]
    got = events[-1].get("records") if events else None
    print(f"  DSEService \"backend\": \"tpu\" request: {len(got or [])} "
          f"records in {service_s:.3f} s, == the engine's: {got == want}",
          flush=True)
    if got != want:
        failures.append("tpu service: records differ from the engine's")

    # (e) the example as a process of its own on the card
    rc, out, err, example_s, _ = _run_entry_point(
        [str(ROOT / "examples" / "torch_dse_cim.py"), "--backend", "tpu",
         "--workload", "gemma3-1b"])
    print(f"  examples/torch_dse_cim.py --backend tpu --workload gemma3-1b: "
          f"exit {rc} in {example_s:.1f} s; "
          + " / ".join(out.strip().splitlines()[:3]), flush=True)
    if rc != 0:
        failures.append(f"tpu example: exit {rc}: {err[-1500:]!r}")

    # (f) the accelerator-mode analysis launches none of K1-K8
    launches = {**accel.launch_counts(), **cim_kernels.launch_counts()}
    print("  kernel launches in process over the phase (none expected): "
          + json.dumps(launches), flush=True)
    if any(launches.values()):
        failures.append(f"tpu: kernels launched on the accelerator-mode "
                        f"path: {launches}")
    phase_s = time.perf_counter() - t_phase
    print(f"accelerator-mode DSE: {phase_s:.3f} s on "
          f"{torch.cuda.get_device_name(0)} ({smi})", flush=True)
    return dict(workloads=per_workload, backward=backward, grid=grid,
                reference_analyses=same, full=full, service_s=service_s,
                example=dict(rc=rc, seconds=example_s,
                             lines=out.strip().splitlines()),
                launches=launches, phase_s=phase_s, failures=failures)


def _popen(argv, env_extra=None):
    """Start one of the port's entry points as a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, timeout):
    """(exit code, stdout, stderr) of a started process; one that outlives
    ``timeout`` is killed and reported as exit code 124."""
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return 124, out, err


def _json_line(text):
    return json.loads(next(line for line in text.splitlines()
                           if line.startswith("{")))


def sharded_phase(dev, smi):
    """Phase 14: the sharded path.  (a) The dry run at published widths:
    each cell of ``launch.fixtures.PHASE_CELLS`` recorded per device by
    ``python -m repro_torch.launch.dryrun --check`` in a process of its own
    (a fake process group of 256 or 512 ranks, meshes of device type cuda,
    meta DTensors: nothing allocated), all at once; each must record ok
    with collective bytes > 0 and pass its FLOP checks.  (b) The spec trees
    of the ten archs at published widths == the committed reference specs;
    the port's ``cell_roofline`` on the committed records == the
    reference's rows; ``python -m repro_torch.bench roofline`` on this run's
    records.  (c) ``launch.serve`` and ``launch.train`` (gemma3-1b reduced,
    f32) with ``--model-parallel 2``, which one card runs as (1, 1): tokens
    and losses == the ``--model-parallel 1`` runs.  (d) ``elastic_remesh()``
    in a process on the card: (1, 1).  (e) No K1-K8 launch: each dry-run
    record and each driver's JSON line holds the launches of every kernel
    over its own run, and their sum must be 0.  Returns the summary for the
    detail file (``failures`` lists misses)."""
    from repro_torch.core import roofline
    from repro_torch.dist import fixtures as spec_fixtures
    from repro_torch.launch import fixtures as launch_fixtures

    t_phase = time.perf_counter()
    failures = []
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sharded_"))
    dry_dir = tmp / "dryrun"

    # (a) the six cells and (c)/(d) the drivers, all started at once
    cells = {}
    for arch, shape, mesh in launch_fixtures.PHASE_CELLS:
        cells[(arch, shape, mesh)] = (time.perf_counter(), _popen(
            ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--device", "cuda", "--out",
             str(dry_dir), "--force", "--check"],
            {"OMP_NUM_THREADS": "1"}))
    common = ["--device", "cuda", "--arch", "gemma3-1b", "--dtype", "float32"]
    drivers = {}
    for mp in (1, 2):
        drivers[("serve", mp)] = _popen(
            ["-m", "repro_torch.launch.serve", *common, "--batch", "4",
             "--prompt-len", "64", "--gen", "8", "--model-parallel", str(mp)])
        drivers[("train", mp)] = _popen(
            ["-m", "repro_torch.launch.train", *common, "--batch", "4",
             "--seq-len", "64", "--steps", "4", "--log-every", "1",
             "--save-every", "0", "--ckpt-dir", str(tmp / f"ckpt{mp}"),
             "--model-parallel", str(mp)])
    remesh = _popen(["-c", "import json; from repro_torch.dist.sharding "
                     "import mesh_axes; from repro_torch.ft.manager import "
                     "elastic_remesh; print(json.dumps(mesh_axes("
                     "elastic_remesh())))"])

    # (b) while those run: the spec trees and the reference's rows
    t0 = time.perf_counter()
    spec_bad = spec_fixtures.mismatches(spec_fixtures.port_records(),
                                        spec_fixtures.load())
    spec_s = time.perf_counter() - t0
    if spec_bad:
        failures.append(f"sharded: spec trees differ from the reference's: "
                        f"{spec_bad[:8]}")
    doc = launch_fixtures.load_roofline()
    rows_equal = sum(roofline.cell_roofline(r) == row
                     for r, row in zip(doc["records"], doc["rows"]))
    if rows_equal != len(doc["rows"]):
        failures.append(f"sharded: cell_roofline == the reference's on "
                        f"{rows_equal} of {len(doc['rows'])} records")
    print(f"sharded path: spec trees of {len(spec_fixtures.MESHES)} meshes "
          f"x 10 archs == the reference's: {not spec_bad} ({spec_s:.2f} s); "
          f"cell_roofline == the reference's on {rows_equal}/"
          f"{len(doc['rows'])} committed records", flush=True)

    records = {}
    for key, (t_start, proc) in cells.items():
        rc, out, err = _finish(proc, 900)
        secs = time.perf_counter() - t_start
        arch, shape, mesh = key
        path = dry_dir / mesh / f"{arch}__{shape}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        rec["process_s"] = secs
        records[f"{arch}/{shape}/{mesh}"] = rec
        if rc != 0 or not rec.get("ok"):
            failures.append(f"sharded: dry run {arch} x {shape} x {mesh}: "
                            f"exit {rc}: {rec.get('error')} {err[-1500:]!r}")
            continue
        coll = rec["collectives"]
        if coll["total"] <= 0:
            failures.append(f"sharded: {arch} x {shape} x {mesh} recorded no "
                            f"collective bytes")
        chk = rec["flop_checks"]
        by_kind = {k: v for k, v in coll.items()
                   if not k.endswith("_count") and k != "total"}
        print(f"  dry run {arch} x {shape} x {mesh} ({rec['n_devices']} "
              f"devices): record {rec['record_s']} s (process done "
              f"{secs:.1f} s after its start), {rec['eqns']} eqns, {rec['flops_per_device']:.4e} "
              f"FLOP/device, {rec['bytes_accessed_per_device']:.4e} B/device, "
              f"collective B/device {coll['total']:.4e} {json.dumps(by_kind)}; "
              f"world-1 {chk['world1_flops']:.4e} FLOP == FlopCounterMode "
              f"{chk['world1_equals_counter']}, data strategy "
              f"{chk['data_flops_per_device']:.4e} == world-1 / "
              f"{chk['data_size']} {chk['data_is_world1_over_data']}, auto "
              f"within [world-1 / {chk['n_devices']}, world-1 / "
              f"{chk['data_size']}] {chk['auto_within_bounds']}", flush=True)
    dry_s = max((r.get("process_s", 0.0) for r in records.values()),
                default=0.0)

    rc, out, err = _finish(_popen(["-m", "repro_torch.bench", "--out",
                                   str(tmp / "bench"), "roofline"],
                                  {"DRYRUN_DIR": str(dry_dir)}), 300)
    if rc != 0:
        failures.append(f"sharded: bench roofline: exit {rc}: {err[-1500:]!r}")
    print("\n".join(line for line in out.splitlines()
                    if "Roofline" in line or " C " in line), flush=True)
    own_rows = [roofline.cell_roofline(r) for r in records.values()
                if r.get("ok")]
    print(roofline.markdown_table(own_rows), flush=True)

    # (c) the drivers: --model-parallel 2 runs as (1, 1), values ==
    driven = {}
    for key, proc in drivers.items():
        rc, out, err = _finish(proc, 600)
        if rc != 0:
            failures.append(f"sharded: {key[0]} --model-parallel {key[1]}: "
                            f"exit {rc}: {err[-1500:]!r}")
            continue
        driven[key] = (_json_line(out), out)
    if len(driven) == 4:
        s1, s2 = driven[("serve", 1)][0], driven[("serve", 2)][0]
        t1, t2 = driven[("train", 1)][0], driven[("train", 2)][0]
        same_tokens = s1["tokens"] == s2["tokens"]
        same_losses = t1["losses"] == t2["losses"]
        meshes = {f"{k[0]}/{k[1]}": v[0]["mesh"] for k, v in driven.items()}
        if not (same_tokens and same_losses):
            failures.append(f"sharded: --model-parallel 2 differs from 1: "
                            f"tokens {same_tokens}, losses {same_losses}")
        if any(m != {"data": 1, "model": 1} for m in meshes.values()) or \
                "mesh={'data': 1, 'model': 1}" not in driven[("train", 2)][1]:
            failures.append(f"sharded: a driver on one card did not run "
                            f"as (1, 1): {meshes}")
        print(f"  drivers, gemma3-1b reduced f32 on the card: serve "
              f"--model-parallel 2 tokens == --model-parallel 1: "
              f"{same_tokens}; train losses {t2['losses']} == "
              f"{t1['losses']}: {same_losses}; meshes {meshes}", flush=True)

    # (d) elastic_remesh on the card
    rc, out, err = _finish(remesh, 300)
    remeshed = _json_line(out) if rc == 0 else None
    if remeshed != {"data": 1, "model": 1}:
        failures.append(f"sharded: elastic_remesh() gave {remeshed}: "
                        f"exit {rc}: {err[-1500:]!r}")
    print(f"  elastic_remesh() on the card: {remeshed}", flush=True)

    # (e) the sharded path launches none of K1-K8: the sum of the counts
    # each dry-run cell and each driver reported for its own run
    runs = {f"dryrun {k}": r.get("kernel_launches")
            for k, r in records.items()}
    runs.update({f"{k[0]} --model-parallel {k[1]}":
                 v[0].get("kernel_launches") for k, v in driven.items()})
    unreported = sorted(k for k, v in runs.items() if v is None)
    launches = collections.Counter()
    for counts in runs.values():
        launches.update(counts or {})
    launches = dict(launches)
    print(f"  kernel launches summed over the {len(runs)} runs of the phase "
          f"(none expected): {json.dumps(launches)}", flush=True)
    if unreported or len(runs) != len(cells) + len(drivers):
        failures.append(f"sharded: runs without kernel counts: "
                        f"{unreported}, {len(runs)} of "
                        f"{len(cells) + len(drivers)} runs read")
    if any(launches.values()):
        failures.append(f"sharded: kernels launched: {launches}")
    phase_s = time.perf_counter() - t_phase
    print(f"sharded path: {phase_s:.3f} s (the dry-run processes "
          f"{dry_s:.1f} s at most) on {torch.cuda.get_device_name(0)} "
          f"({smi})", flush=True)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(records=records, spec_trees_equal=not spec_bad,
                reference_rows_equal=rows_equal, own_rows=own_rows,
                drivers={f"{k[0]}/{k[1]}": v[0] for k, v in driven.items()},
                elastic_remesh=remeshed, launches=launches,
                phase_s=phase_s, failures=failures)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import accel
    from repro_torch.core.accel import _build
    from repro_torch.core.accel import replay as replay_mod
    from repro_torch.core.accel.pallas_ops import segment_max, segment_sum
    from repro_torch.core.accel.place import (
        _flat_arrays, place_arrays, place_candidates, place_sorted,
        placement_lists)
    from repro_torch.core.accel.replay import replay_columns_batch
    from repro_torch.core.cache import SPM_1M
    from repro_torch.core.isa import OP_STORE
    from repro_torch.core.offload import (OffloadConfig, _candidates,
                                         select_candidates)
    from repro_torch.kernels import CSRC as CIM_CSRC
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
    per_source = _build.build([*_build.sources().values(),
                               *sorted(CIM_CSRC.glob("*.cu")), PROBES])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(per_source)}", flush=True)
    for src in ("flash_attention", "segment_reduce", "replay", "mlstm_chunk"):
        for row in ptxas_summary(_build.build_logs.get(src, "")):
            # mLSTM: the xlstm-125m instantiations (dh = 192) and the
            # untemplated kernels
            if src != "mlstm_chunk" or "192" in row or "<" not in row:
                print(f"  ptxas {src}: {row}", flush=True)
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
    # latency floors: the geometries run side by side, one block each.  A
    # walk of one access a step probes the first level (shared memory when
    # the wrapper keeps it there, else the card's L2) once per access, and
    # the second level (the card's L2) once per first-level miss: the
    # serial floor.  The kernel probes a step of replay_mod.STEP accesses
    # at once and again after each miss: its chain is one first-level
    # probe per step and per miss, plus the misses' second-level probes
    l1_smem = replay_mod.first_level_shared(geos, replay_mod.word_bytes(
        n_acc, int(addrs.max()) // 64, geos))
    l1_ns = smem_ns if l1_smem else l2_ns
    floor, chunk_floor = {}, {}
    for (key, g), r in zip(fixtures.CACHES.items(), got):
        l1_misses = r[4][f"{g[0].name}_misses"]
        floor[key] = (n_acc * l1_ns + l1_misses * l2_ns) * 1e-6
        chunk_floor[key] = ((-(-n_acc // replay_mod.STEP) + l1_misses) * l1_ns
                            + l1_misses * l2_ns) * 1e-6
    lat_ms = max(floor.values())
    chunk_ms = max(chunk_floor.values())
    # fixed cost (state clearing, launch, wrapper) and the hit path alone
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    empty_ms = event_ms(lambda: replay_columns_batch(
        empty, empty.to(torch.bool), geos), 5)
    one_line = torch.zeros_like(addrs)
    reads = torch.zeros_like(is_w)
    hit_ms = event_ms(lambda: replay_columns_batch(one_line, reads, geos), 5)
    hit_ns = (hit_ms - empty_ms) * 1e6 / n_acc
    astar_ns = (ms - empty_ms) * 1e6 / n_acc
    # the same three streams on the device alone (profiler: the replay
    # kernels and any memset; no host work of the wrapper)
    replay_dev = {}
    for key, a, w in (("astar", addrs, is_w), ("all-hit", one_line, reads),
                      ("empty", empty, empty.to(torch.bool))):
        names = {}
        replay_dev[key] = dict(zip(("device_ms", "device_events_per_call"),
                                   profiled_device_ms(
            lambda: replay_columns_batch(a, w, geos), 5, names)),
                               events=names)
    dev_hit_ns = (replay_dev["all-hit"]["device_ms"]
                  - replay_dev["empty"]["device_ms"]) * 1e6 / n_acc \
        if replay_dev["empty"]["device_ms"] is not None else None
    dev_astar_ns = (replay_dev["astar"]["device_ms"]
                    - replay_dev["empty"]["device_ms"]) * 1e6 / n_acc \
        if replay_dev["empty"]["device_ms"] is not None else None
    l1_misses = {key: r[4][f"{g[0].name}_misses"]
                 for (key, g), r in zip(fixtures.CACHES.items(), got)}
    kernels["replay"] = dict(
        twin="src/repro/core/accel/replay.py::replay_columns_batch",
        source="src/repro_torch/core/accel/csrc/replay.cu",
        replaces="src/repro/core/accel/replay.py:202",
        equal=True, max_abs_err=replay_err, ms=ms, plain_ms=plain,
        bound_ms=rb, bound_by=rb_by, library_ms=None,
        shape=f"{n_acc} accesses x {len(geos)} geometries (one launch)",
        latency_bound_ms=lat_ms, latency_bound_per_geometry_ms=floor,
        chunk_latency_bound_ms=chunk_ms,
        l2_round_trip_ns=l2_ns, smem_round_trip_ns=smem_ns,
        empty_stream_ms=empty_ms, all_hit_ns_per_access=hit_ns,
        astar_ns_per_access=astar_ns, device=replay_dev,
        device_all_hit_ns_per_access=dev_hit_ns,
        device_astar_ns_per_access=dev_astar_ns, l1_misses=l1_misses)
    print(f"replay: equal on {len(geos) + 1} geometries; {ms:.3f} ms "
          f"kernel, {plain:.1f} ms plain (host); latency floor of a "
          f"serial walk {lat_ms:.3f} ms ({ms / lat_ms:.2f}x), of the "
          f"kernel's stepped chain {chunk_ms:.4f} ms ({ms / chunk_ms:.1f}x);"
          f" empty stream "
          f"{empty_ms:.4f} ms; ns per access (events, less the empty "
          f"stream): all-hit {hit_ns:.1f}, astar {astar_ns:.1f}; first-"
          f"level misses {json.dumps(l1_misses)}", flush=True)
    print("replay device only (profiler): " + "; ".join(
        f"{k} {ms_text(v['device_ms'])} in "
        f"{v['device_events_per_call']:g} event(s) a call"
        for k, v in replay_dev.items())
          + f"; ns per access all-hit {dev_hit_ns}, astar {dev_astar_ns}",
          flush=True)

    # segment reductions at the main path's largest shape: astar's
    # placement under 32K+256K / both
    tr = attach_cache_results_batch(astar, [geos[0]], device=dev)[0]
    cfg = OffloadConfig(cim_levels=("L1", "L2"))
    select_candidates(tr.trace, cfg=cfg, device=dev)   # memoizes the partition
    part = tr.trace._struct["partitions"][cfg.partition_key()]
    leaf_seq, leaf_off, acc_seq, _, _ = _flat_arrays(part, tr.trace, cfg)
    n_seg = len(part.protos)
    leaf_pid = torch.repeat_interleave(
        torch.arange(n_seg, dtype=torch.int32, device=dev), leaf_off.diff())
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
        i64 = i.to(torch.int64)
        # 50 calls back to back: the rate at which the host path enqueues
        ms, lib_ms = turns_ms(lambda: op(v, i, n_seg),
                              lambda: lib_call(v, i64, n_seg), 50)
        plain = host_ms(lambda: op(v_cpu, i_cpu, n_seg), 20)
        dev_ms, per_call = profiled_device_ms(lambda: op(v, i, n_seg), 50)
        lib_dev_ms, lib_per_call = profiled_device_ms(
            lambda: lib_call(v, i64, n_seg), 50)
        if dev_ms is not None and round(per_call) != 1:
            fail(f"{name} ran {per_call} kernels a call at n_segments="
                 f"{n_seg}, not one launch without a fill")
        n = v.numel()
        bound, by = bytes_bound_ms(n * 8 + n_seg * 4, n)
        twin_line = 88 if name == "segment_sum" else 96
        kernels[name] = dict(
            twin=f"src/repro/core/accel/pallas_ops.py::{name}",
            source="src/repro_torch/core/accel/csrc/segment_reduce.cu",
            replaces=f"src/repro/core/accel/pallas_ops.py:{twin_line}",
            equal=True, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=lib_ms,
            device_ms=dev_ms, kernels_per_call=per_call,
            library_device_ms=lib_dev_ms,
            library_kernels_per_call=lib_per_call,
            shape=f"n={n}, n_segments={n_seg}")
        print(f"{name}: equal on {len(cases)} cases; {ms:.4f} ms kernel, "
              f"{lib_ms:.4f} ms library (events, 50 calls, in turns), "
              f"{plain:.3f} ms plain (host); device only (profiler): "
              f"kernel {ms_text(dev_ms)} in {per_call:g} launch(es) a "
              f"call, library {ms_text(lib_dev_ms)} in {lib_per_call:g}",
              flush=True)

    # the two paths of the segment kernels on either side of the
    # shared-memory path's element limit, at astar's segment count, timed
    # in turns
    limit = 65536                  # SMEM_ELEMENTS, csrc/segment_reduce.cu
    sides = {}
    for n in (limit, limit + 1):
        ids = torch.randint(0, n_seg, (n,), generator=gen, dtype=torch.int32)
        ids = ids.sort().values.to(dev)
        vals = torch.ones(n, dtype=torch.int32, device=dev)
        if not torch.equal(segment_sum(vals, ids, n_seg).cpu(),
                           segment_sum(vals.cpu(), ids.cpu(), n_seg)):
            fail(f"segment_sum differs from its plain version at n={n}")
        sides[n] = lambda vals=vals, ids=ids: segment_sum(vals, ids, n_seg)
    threshold = dict(zip((limit, limit + 1), (
        dict(ms=ms) for ms in turns_ms(sides[limit], sides[limit + 1], 50))))
    for n, fn in sides.items():
        dev_ms, per_call = profiled_device_ms(fn, 50)
        threshold[n].update(device_ms=dev_ms, kernels_per_call=per_call)
        print(f"segment_sum n={n}, n_segments={n_seg}: "
              f"{threshold[n]['ms']:.4f} ms (events, in turns), device "
              f"only {ms_text(dev_ms)} in {per_call:g} launch(es) a call",
              flush=True)
    detail["segment_threshold"] = threshold

    # placement (K4): the kernel against its plain version (on the CPU
    # trace of the same workload) on the astar placement, and against the
    # composition of segment kernels and a sort (place_sorted) on the card;
    # then on a synthetic partition under each CiM level set
    tr_cpu = attach_cache_results_batch(
        fixtures.load_structural("astar", device="cpu"), [geos[0]],
        device="cpu")[0]
    select_candidates(tr_cpu.trace, cfg=cfg, device="cpu")
    part_cpu = tr_cpu.trace._struct["partitions"][cfg.partition_key()]
    want = place_arrays(part_cpu, tr_cpu.trace, cfg)
    if not torch.equal(place_arrays(part, tr.trace, cfg).cpu(), want):
        fail("place differs from its plain version on the astar placement")
    if not torch.equal(place_sorted(part, tr.trace, cfg).cpu(), want):
        fail("place_sorted differs from the plain placement on astar")
    if placement_lists(part, tr.trace, cfg) != want.tolist():
        fail("placement_lists differs from the plain placement on astar")
    if place_candidates(part, tr.trace, cfg) != place_candidates(
            part_cpu, tr_cpu.trace, cfg):
        fail("placement on the card differs from its plain version")
    for levels in (("L1", "L2"), ("L1",), ("L2",)):
        scfg = OffloadConfig(cim_levels=levels)
        for seed in (1, 2):
            spart, sct = synthetic_placement(seed)
            sct_dev = types.SimpleNamespace(
                **{c: getattr(sct, c).to(dev) for c in ("level", "addr",
                                                        "bank")},
                device=dev, _struct={})
            if not torch.equal(place_arrays(spart, sct_dev, scfg).cpu(),
                               place_arrays(spart, sct, scfg)):
                fail(f"place differs from its plain version on the "
                     f"synthetic partition {seed}, levels {levels}")
    print(f"place: equal on the astar placement and on 2 synthetic "
          f"partitions x 3 level sets (runs of up to "
          f"{SYNTHETIC_RUN} accesses)", flush=True)

    # its time: events over calls in a row (the host path's enqueue rate),
    # the plain version, the whole call with the join; then where a call's
    # time goes, for the kernel and for the composition (place_sorted)
    ms = event_ms(lambda: place_arrays(part, tr.trace, cfg), 50)
    plain = host_ms(lambda: place_arrays(part_cpu, tr_cpu.trace, cfg), 5)
    lists = want.tolist()
    join = lambda: _candidates(part.protos, *lists)
    after = placement_split(lambda: place_arrays(part, tr.trace, cfg),
                            lambda: placement_lists(part, tr.trace, cfg),
                            join)
    before = placement_split(lambda: place_sorted(part, tr.trace, cfg),
                             lambda: place_sorted(part, tr.trace,
                                                  cfg).tolist(), join)
    call_ms = host_ms(lambda: place_candidates(part, tr.trace, cfg), 20)
    for label, sp in (("place (one kernel)", after),
                      ("place_sorted (segment kernels + sort)", before)):
        print(f"{label} split: {sp['kernels_per_call']:g} kernels and "
              f"{sp['copies_per_call']:g} copies a call on the device, "
              f"device {ms_text(sp['device_ms'])}; call to lists on the "
              f"host {sp['lists_ms']:.4f} ms; join (_candidates) "
              f"{sp['join_ms']:.4f} ms (host clock)", flush=True)
        print("  device events a call: " + json.dumps(
            {k: round(v, 2) for k, v in sorted(
                sp["device_events"].items(), key=lambda kv: -kv[1])}),
              flush=True)
    if after["device_ms"] is not None and \
            round(after["kernels_per_call"]) != 1:
        fail(f"place ran {after['kernels_per_call']} kernels a call, not "
             f"one")
    # bytes: the flat arrays, the trace columns gathered through them, one
    # bank per proto, and four int32 results per proto
    tt = tr.trace
    n_leaf, n_acc_p = leaf_seq.numel(), acc_seq.numel()
    place_bytes = (
        n_leaf * (leaf_seq.element_size() + tt.level.element_size())
        + n_acc_p * (acc_seq.element_size() + tt.level.element_size()
                     + tt.addr.element_size())
        + n_seg * (3 * 8 + tt.bank.element_size() + 4 * 4))
    place_bound, place_by = bytes_bound_ms(place_bytes, n_leaf + n_acc_p)
    kernels["place"] = dict(
        twin="src/repro/core/accel/place.py::place_candidates_jax",
        source="src/repro_torch/core/accel/csrc/place.cu",
        replaces="src/repro/core/accel/place.py:144", equal=True,
        max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=place_bound,
        bound_by=place_by, library_ms=None, device_ms=after["device_ms"],
        kernels_per_call=after["kernels_per_call"],
        lists_ms=after["lists_ms"], join_ms=after["join_ms"],
        call_ms=call_ms, split_before=before, split_after=after,
        shape=f"{n_leaf} leaves, {n_acc_p} accesses, {n_seg} protos "
              "(astar, 32K+256K, both levels)")
    print(f"place (K4): {ms:.4f} ms kernel (events, 50 calls), "
          f"{plain:.3f} ms plain (host); whole call with the join "
          f"{call_ms:.4f} ms (host clock); bound {place_bound:.6f} ms "
          f"({place_by})", flush=True)

    # ------------------------------------------------ 3b. trace frontend
    traces, trace_detail = trace_phase(dev)
    detail["trace_frontend"] = trace_detail
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if trace_detail["failures"]:
        fail(f"trace frontend differs from the reference: "
             f"{trace_detail['failures']}")

    # ------------------------------------------------------- 4. main path
    # the 306 design points through DSEEngine.run, as a user sweeps them:
    # the default thread executor (one batched replay per workload) with
    # one pricing thread, so the spans' self times telescope to the wall
    from repro_torch import obs
    from repro_torch.dse import DSEEngine
    golden = fixtures.reference_reports()["workloads"]
    space = fixtures.design_point_space()
    accel.reset_launch_counts()
    tracer = obs.enable(obs.Tracer())
    t0 = time.perf_counter()
    eng = DSEEngine(max_workers=1, device=dev)
    results = eng.run(space)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    obs.disable()
    launches = accel.launch_counts()
    att = obs.stage_attribution(tracer.spans())
    stage = {cat: st["self_s"] for cat, st in att["stages"].items()}
    per_workload = {w: sum(per.values())
                    for w, per in att["workloads"].items()}
    n_rec = n_equal = 0
    mismatches = []
    for name, (records, counters) in fixtures.engine_design_points(
            eng, results).items():
        want = fixtures.golden_by_key(golden[name]["records"])
        n_rec += len(records)
        for key, rec in records.items():
            if rec == want.get(key):
                n_equal += 1
            else:
                mismatches.append((name, rec, want.get(key)))
        if list(records) != list(want):
            mismatches.append((name, "record keys", list(records)))
        if counters != golden[name]["counters"]:
            mismatches.append((name, "counters", counters))
    stats = results.stats
    print(f"main path: DSEEngine.run over {len(space)} points, {n_rec} "
          f"records, {n_equal} equal, {n_rec - n_equal} mismatched; "
          f"{wall:.2f} s wall; engine " + json.dumps(stats), flush=True)
    print("stage seconds (spans' self time, stage_attribution; coverage "
          f"{att['coverage']:.4f}): " + json.dumps(
              {k: round(v, 3) for k, v in stage.items()}), flush=True)
    print("launches: " + json.dumps(launches), flush=True)
    detail.update(stage_seconds=stage, stage_attribution=att,
                  workload_seconds=per_workload, main_path_wall_s=wall,
                  main_path_stats=stats, launches=launches,
                  mismatches=[repr(m) for m in mismatches[:50]],
                  kernels=kernels)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if mismatches or n_rec != 306 or n_equal != n_rec:
        for m in mismatches[:10]:
            print("MISMATCH", m)
        fail(f"{len(mismatches)} mismatches against the reference reports")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")
    if launches["replay"] != stats["replay_batches"] \
            or launches["place"] != stats["offload_builds"]:
        fail(f"main path launches {launches} differ from the engine's "
             f"builds {stats}")

    # the same sweep again under torch.profiler, on a fresh engine: summed
    # device time per kernel, and the device's busy share of the traced
    # sweep's wall time (the trace VM included)
    def sweep():
        DSEEngine(max_workers=1, device=dev).run(space)

    events, traced_wall = device_ms_by_kernel(sweep)
    busy = sum(ms for ms, _ in events.values())
    per_kernel = {}
    for name in MAIN_PATH_KERNELS:
        hits = [(ms, n) for key, (ms, n) in events.items()
                if f"{name}_kernel" in key]
        per_kernel[name] = dict(device_ms=sum(ms for ms, _ in hits),
                                launches=sum(n for _, n in hits))
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:8]
    detail["main_path_profile"] = dict(
        traced_wall_s=traced_wall, device_busy_ms=busy,
        per_kernel=per_kernel,
        events={k: dict(ms=v[0], count=v[1]) for k, v in events.items()})
    print(f"main path under the profiler: {traced_wall:.2f} s wall, device "
          f"busy {busy:.3f} ms ({busy / 1e3 / traced_wall:.4f} of the wall; "
          f"idle share {1 - busy / 1e3 / traced_wall:.4f}); per kernel "
          + json.dumps({k: {x: round(y, 4) for x, y in v.items()}
                        for k, v in per_kernel.items()})
          + "; largest device events " + json.dumps(
              {k[:60]: [round(v[0], 4), v[1]] for k, v in top}), flush=True)
    kernels["replay"]["main_path_device_ms"] = per_kernel["replay"]
    kernels["place"]["main_path_device_ms"] = per_kernel["place"]

    # ---------------------------------------------------- 5. kernels path
    cim_table, cim_launches, cim_path_s = cim_kernels_phase(dev)
    kernels.update(cim_table)
    launches.update(cim_launches)
    detail.update(kernels=kernels, launches=launches,
                  kernels_path_wall_s=cim_path_s)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))

    # ------------------------------------------------ 6. DSE and artifacts
    dse, dse_launches = dse_phase(dev)
    print(smi, flush=True)
    detail["dse"] = dse
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if dse["failures"]:
        for f in dse["failures"]:
            print("MISMATCH", f)
        fail(f"{len(dse['failures'])} failures in the DSE phase")
    for name in MAIN_PATH_KERNELS:
        kernels[name]["dse_launches"] = dse_launches[name]

    # ------------------------------------------------------- 7. sampling
    sampled, sampled_launches = sampling_phase(dev)
    detail["sampling"] = sampled
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if sampled["failures"]:
        for f in sampled["failures"]:
            print("MISMATCH", f)
        fail(f"{len(sampled['failures'])} failures in the sampling phase")
    for name in MAIN_PATH_KERNELS:
        if sampled_launches[name] <= 0:
            fail(f"kernel {name} was never launched on the sampled path")
        kernels[name]["sampled_launches"] = sampled_launches[name]
        kernels[name]["sampled_device_ms"] = sampled["device_ms"][name]
    kernels["replay"]["sampled_stream"] = sampled["k1"]

    # -------------------------------------------------------- 9. service
    served, served_launches = service_phase(dev, smi)
    detail["service"] = served
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if served["failures"]:
        for f in served["failures"]:
            print("MISMATCH", f)
        fail(f"{len(served['failures'])} failures in the service phase")
    for name in MAIN_PATH_KERNELS:
        kernels[name]["service_launches"] = served_launches[name]

    # --------------------------------------------------- 10. entry points
    entry, entry_launches = entry_points_phase(dev, traces, smi)
    detail["entry_points"] = entry
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if entry["failures"]:
        for f in entry["failures"]:
            print("MISMATCH", f)
        fail(f"{len(entry['failures'])} failures in the entry-points phase")
    for name in MAIN_PATH_KERNELS:
        kernels[name]["entry_point_launches"] = entry_launches[name]

    # --------------------------------------------------------- 11. serve
    serve = serve_phase(dev, smi)
    detail["serve"] = serve
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if serve["failures"]:
        for f in serve["failures"]:
            print("MISMATCH", f)
        fail(f"{len(serve['failures'])} failures in the serve phase")

    # --------------------------------------------------------- 12. train
    trained = train_phase(dev, smi)
    detail["train"] = trained
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if trained["failures"]:
        for f in trained["failures"]:
            print("MISMATCH", f)
        fail(f"{len(trained['failures'])} failures in the train phase")

    # ---------------------------------------------- 13. accelerator-mode DSE
    tpu = tpu_dse_phase(dev, smi)
    detail["tpu_dse"] = tpu
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if tpu["failures"]:
        for f in tpu["failures"]:
            print("MISMATCH", f)
        fail(f"{len(tpu['failures'])} failures in the accelerator-mode "
             f"DSE phase")

    # --------------------------------------------------- 14. sharded path
    sharded = sharded_phase(dev, smi)
    detail["sharded"] = sharded
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if sharded["failures"]:
        for f in sharded["failures"]:
            print("MISMATCH", f)
        fail(f"{len(sharded['failures'])} failures in the sharded-path phase")

    # --------------------------------------------------------- 15. result
    table = []
    for name in (*accel.KERNELS, *cim_launches):
        k = kernels[name]
        table.append({"name": name, "route": "cuda", "source": k["source"],
                      "replaces": k["replaces"], "twin": k["twin"],
                      "launches": launches[name],
                      "tolerance": k.get("tolerance", 0),
                      **{x: k[x] for x in ("equal", "within_tolerance")
                         if x in k},
                      "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                      "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                      "bound_by": k["bound_by"],
                      "library_ms": k["library_ms"], "shape": k["shape"],
                      **{x: k[x] for x in (
                          "latency_bound_ms", "latency_bound_per_geometry_ms",
                          "chunk_latency_bound_ms",
                          "l2_round_trip_ns", "smem_round_trip_ns",
                          "empty_stream_ms", "all_hit_ns_per_access",
                          "astar_ns_per_access", "device_all_hit_ns_per_access",
                          "device_astar_ns_per_access", "l1_misses",
                          "main_path_device_ms", "dse_launches",
                          "sampled_launches", "sampled_device_ms",
                          "service_launches", "entry_point_launches",
                          "sampled_stream",
                          "f32_bound_ms", "f32_bound_share",
                          "chain_bound_ms", "share_of_tolerance",
                          "launches_per_prefill",
                          "prefill_ms", "bf16_tolerance", "bf16_max_abs_err",
                          "bf16_share_of_tolerance", "library_call",
                          "device_ms", "kernels_per_call",
                          "library_device_ms", "library_kernels_per_call",
                          "lists_ms", "join_ms", "call_ms", "split_before",
                          "split_after", "bound_share", "variants")
                         if x in k}})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
