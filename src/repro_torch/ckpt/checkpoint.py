"""Checkpointing: atomic-rename npz snapshots, async save, auto-resume
(port of ``repro.ckpt.checkpoint``).

Crash-safety contract: a checkpoint directory only ever contains complete
snapshots -- writes go to ``<step>.npz.tmp`` and are os.rename'd (atomic on
POSIX) once fsync'd, so a preempted save never corrupts restart state.
``CheckpointManager`` keeps the newest ``keep`` snapshots, saves on a
background thread (training continues through I/O), and ``restore_latest``
implements auto-resume after node failure.

The file is the reference's: one npz entry per leaf, keyed by the
``/``-joined dict path in sorted key order (``params/layers/wq``,
``opt/m/...``, ``step``), bf16 widened to f32 and cast back on restore,
so a snapshot either package writes loads in the other.
"""
from __future__ import annotations

import concurrent.futures
import os
import pathlib
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.tree import leaves_with_path, tree_map

_STEP_RE = re.compile(r"^(\d+)\.npz$")


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array; bf16 widened losslessly to f32 (npz has no
    bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.kind == "V" else arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in leaves_with_path(tree)}


def _unflatten(template, arrays: Dict[str, np.ndarray], prefix=()):
    """``template``'s tree with each leaf read from ``arrays``, cast to the
    leaf's dtype and shape, on the leaf's device."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], arrays, (*prefix, str(k)))
                for k in sorted(template)}
    arr = np.asarray(arrays["/".join(prefix)])
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=template.device, dtype=template.dtype).reshape(
            template.shape)
    if hasattr(template, "dtype"):
        return arr.astype(template.dtype).reshape(template.shape)
    return arr


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"{step}.npz"
    tmp = d / f"{step}.npz.tmp"
    arrays = _flatten(state)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)                                 # atomic publish
    return str(final)


def load_checkpoint(path: str, template: Any) -> Any:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return _unflatten(template, arrays)


def latest_step(directory: str) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := _STEP_RE.match(p.name))]
    return max(steps) if steps else None


def _snapshot(tree):
    """The state copied to the host now, so later steps cannot change what
    the background save writes."""
    return tree_map(lambda leaf: leaf.detach().to("cpu", copy=True)
                    if isinstance(leaf, torch.Tensor) else np.array(leaf),
                    tree)


class CheckpointManager:
    """Async, bounded-retention checkpointing with auto-resume."""

    def __init__(self, directory: str, keep: int = 3, every: int = 50):
        self.dir = pathlib.Path(directory)
        self.keep = keep
        self.every = every
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()
        self._pending: Optional[concurrent.futures.Future] = None  # lint: guarded-by(_lock)

    # -------------------------------------------------------------- save
    def maybe_save(self, step: int, state: Any, *, force: bool = False) -> bool:
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        host_state = _snapshot(state)                     # snapshot now
        self.wait()                                       # one in flight max
        with self._lock:
            self._pending = self._pool.submit(self._save_and_gc, step,
                                              host_state)
        return True

    def _save_and_gc(self, step: int, state: Any) -> None:
        save_checkpoint(str(self.dir), step, state)
        with self._lock:
            steps = sorted(int(m.group(1)) for p in self.dir.iterdir()
                           if (m := _STEP_RE.match(p.name)))
            for s in steps[:-self.keep]:
                (self.dir / f"{s}.npz").unlink(missing_ok=True)

    def wait(self) -> None:
        # take the future under the lock, but block on it outside:
        # _save_and_gc acquires the same lock on the pool thread, so
        # holding it across .result() would deadlock
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    # ------------------------------------------------------------ resume
    def restore_latest(self, template: Any) -> Tuple[Optional[int], Any]:
        """(step, state) of the newest snapshot, or (None, template)."""
        step = latest_step(str(self.dir))
        if step is None:
            return None, template
        state = load_checkpoint(str(self.dir / f"{step}.npz"), template)
        return step, state
