"""Fault tolerance: checkpoint/restart orchestration, straggler detection
and elastic re-meshing (port of ``repro.ft.manager``).

Design (CPU-testable, mesh-agnostic):

* ``StragglerMonitor`` — rolling per-step wall-time statistics; flags steps
  slower than ``threshold`` x the rolling median (ICI-jitter tolerant) and
  recommends mitigation (re-shard victim host's data / restart the worker).
  On a real pod this feeds the control plane; here it logs + counts.

* ``elastic_remesh`` — the largest (data, model) mesh the live ranks
  support: after losing a host, training resumes on fewer ranks with the
  same global batch.

* ``FaultTolerantRunner`` — wraps a train loop with (i) auto-resume from
  the newest checkpoint, (ii) periodic async saves, (iii) a failure hook:
  on any step exception it waits for the snapshot in flight, restores the
  newest durable one and resumes -- the data pipeline's pure
  ``batch_at(step)`` guarantees no data drift across the restart.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.ckpt.checkpoint import CheckpointManager


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times = collections.deque(maxlen=window)
        self.straggles: List[Tuple[int, float]] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; True if this step straggled."""
        is_straggler = False
        if len(self.times) >= max(4, self.window // 4):
            med = statistics.median(self.times)
            if seconds > self.threshold * med:
                self.straggles.append((step, seconds))
                is_straggler = True
        self.times.append(seconds)
        return is_straggler

    def report(self) -> Dict[str, Any]:
        med = statistics.median(self.times) if self.times else 0.0
        return {"median_s": med, "n_straggles": len(self.straggles),
                "straggle_steps": [s for s, _ in self.straggles[-8:]]}


def remesh_shape(n_live: int, min_model_parallel: int = 1) -> Tuple[int, int]:
    """(data, model) of :func:`elastic_remesh` over ``n_live`` ranks: the
    model axis steps down from ``min_model_parallel`` until it divides."""
    mp = min_model_parallel
    while n_live % mp:
        mp -= 1
    return n_live // mp, mp


def elastic_remesh(min_model_parallel: int = 1, device: str = "cuda"):
    """Build the largest (data, model) mesh the *currently live* ranks of
    the default group support (a world-1 group is made when none exists)
    -- after losing a host, training resumes on fewer ranks with the same
    global batch (per-rank batch grows).  The mesh is on the card unless
    the caller names ``device="cpu"``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import ensure_group, make_mesh
    ensure_group(device)
    return make_mesh(remesh_shape(dist.get_world_size(), min_model_parallel),
                     ("data", "model"), device=device)


@dataclasses.dataclass
class RunReport:
    steps_run: int
    resumed_from: Optional[int]
    failures_recovered: int
    straggler: Dict[str, Any]
    final_metrics: Dict[str, float]


class FaultTolerantRunner:
    def __init__(self, ckpt_dir: str, *, save_every: int = 50, keep: int = 3,
                 max_recoveries: int = 3,
                 ckpt: Optional[CheckpointManager] = None):
        self.ckpt = ckpt or CheckpointManager(ckpt_dir, keep=keep,
                                              every=save_every)
        self.monitor = StragglerMonitor()
        self.max_recoveries = max_recoveries

    def run(self, state: Any, total_steps: int,
            step_fn: Callable[[Any, Any], Tuple[Any, Dict]],
            batch_at: Callable[[int], Any],
            *, on_failure: Optional[Callable[[int, Exception], None]] = None,
            log_every: int = 10,
            fail_at: Optional[int] = None) -> Tuple[Any, RunReport]:
        """Run ``total_steps`` with auto-resume.  ``fail_at`` injects one
        synthetic failure (tests/examples exercise the recovery path)."""
        resumed_from, state = self.ckpt.restore_latest(state)
        start = 0 if resumed_from is None else resumed_from + 1
        failures = 0
        metrics: Dict[str, float] = {}
        injected = [fail_at]
        step = start
        while step < total_steps:
            t0 = time.perf_counter()
            try:
                if injected[0] is not None and step == injected[0]:
                    injected[0] = None
                    raise RuntimeError("injected node failure")
                state, m = step_fn(state, batch_at(step))
                metrics = {k: float(v) for k, v in m.items()}
            except Exception as e:  # noqa: BLE001 — the recovery path
                failures += 1
                if on_failure is not None:
                    on_failure(step, e)
                if failures > self.max_recoveries:
                    raise
                # salvage -> resume from the newest durable snapshot
                self.ckpt.wait()
                resumed, state = self.ckpt.restore_latest(state)
                step = 0 if resumed is None else resumed + 1
                continue
            dt = time.perf_counter() - t0
            if self.monitor.observe(step, dt) and log_every:
                print(f"[ft] straggler at step {step}: {dt:.3f}s", flush=True)
            self.ckpt.maybe_save(step, state)
            if log_every and step % log_every == 0:
                print(f"[train] step {step} " +
                      " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
                      flush=True)
            step += 1
        self.ckpt.maybe_save(total_steps - 1, state, force=True)
        self.ckpt.wait()
        return state, RunReport(total_steps - start, resumed_from, failures,
                                self.monitor.report(), metrics)
