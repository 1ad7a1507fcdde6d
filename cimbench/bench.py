"""One run of one cell: set-up, the measured window, the metrics, the
check against the reference, and the result line.

:func:`run_cell` does the work on any device; ``cimbench/run.py`` is the
command, which insists on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import random
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from cimbench import check, generator
from cimbench.manifest import Manifest, ROOT
from cimbench.yardstick import self_time_by_cat

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class RunView:
    """What a metric reader reads of one run.

    ``units``: the window's completed units, each a dict with ``points``
    (the design points), ``seconds`` (its host-clock duration) and
    ``work`` (the virtual instructions of its sampled analyses, else 0;
    a sampled unit's points are its analyses).
    ``spans``, ``device`` and ``k1_launches`` are set in a traced run
    only: the program's spans of the window, its
    :class:`cimbench.devtrace.DeviceTrace` (``None`` off the card), and
    one ``(accesses, geometries)`` pair per replay-kernel launch."""
    units: List[Dict]
    window_s: float
    setup_s: float
    spans: Optional[List[Dict]] = None
    device: Optional[object] = None
    k1_launches: Optional[List[Tuple[int, int]]] = None

    @property
    def n_points(self) -> int:
        return sum(len(u["points"]) for u in self.units)

    @functools.cached_property
    def self_s(self) -> Dict[str, float]:
        return self_time_by_cat(self.spans or [])


class GcPause:
    """The collector's pauses while open, as ``(start_ns, end_ns)`` on
    ``perf_counter_ns`` (a traced run's only: a callback on every
    collection is not for the measured runs)."""

    def __init__(self):
        self.pauses: List[Tuple[int, int]] = []
        self._t0 = 0
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter_ns()
        else:
            self.pauses.append((self._t0, time.perf_counter_ns()))

    def close(self) -> None:
        gc.callbacks.remove(self._cb)

    def spans(self, epoch_ns: int) -> List[Dict]:
        """The pauses as host spans, so that the device's idle stretches
        during a collection are named by it."""
        return [{"name": "(garbage collection)", "ts_ns": a + epoch_ns,
                 "dur_ns": b - a} for a, b in self.pauses]


def keep_two(units: List[Dict], held: Optional[int],
             draw: random.Random) -> int:
    """After ``units`` gained its newest unit: the index of the unit whose
    engines stay held, drawn uniformly from all of them so far (a
    reservoir of one); every unit's engines but that one's and the
    newest's are dropped."""
    newest, before = len(units) - 1, held
    if draw.randrange(len(units)) == 0:
        held = newest
    for j in {before, newest - 1} - {None, -1, held}:
        units[j]["out"]["engines"] = None
    return held


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             root=ROOT, device: str = "cuda",
             t_start: Optional[float] = None, control: bool = False) -> Dict:
    """Run cell ``name`` once; returns the result line's object.

    ``control`` adds ``"control"``: the numbers compared when the
    reference computed in float32 stands in for the program's records
    (:mod:`cimbench.control`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = Manifest(root)
    cell = man.cell(name)
    config = man.config(cell["config"])
    traffic = generator.Traffic(generator.load(man.traffic_path(
        cell["traffic"])), config, seed)

    import torch
    from cimbench import port
    from cimbench.devtrace import DeviceTrace
    from cimbench.ref.pipeline import Reference

    if device.startswith("cuda"):
        built = port.build_kernels()
        if built:
            _log(f"built {sorted(built)} in {max(built.values()):.1f} s")
    sut = port.Port(traffic, config, device)
    n_warm = sut.warm()
    port.synchronize(device)
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s ({n_warm} warm points)")

    units: List[Dict] = []
    failed = attempted = 0
    tracer = None
    if trace:
        tracer = port.start_tracing()
        epoch_ns = time.time_ns() - time.perf_counter_ns()
    # a pass's engine holds every artifact it built: the window keeps
    # those of the last unit and of one unit drawn from all of them (a
    # reservoir of one), so that its heap does not grow; a sampled
    # window runs few units, and keeps every one
    drops = (traffic.engine_kind == "per_unit"
             and traffic.params.get("sampling") is None)
    draw, held = random.Random(f"{seed}:keep"), None
    gc_pause = GcPause() if trace else None
    launches0 = port.launch_counts()
    with DeviceTrace(device if trace else "cpu") as dt:
        t_win = time.perf_counter()
        for unit in traffic.units():
            attempted += len(unit["points"])
            t0 = time.perf_counter()
            try:
                out = sut.run_unit(unit)
                port.synchronize(device)
            except Exception:        # noqa: BLE001 - a failed unit is counted
                failed += len(unit["points"])
                _log(traceback.format_exc())
                out = None
            t1 = time.perf_counter()
            if out is not None:
                units.append(dict(unit, seconds=t1 - t0, out=out,
                                  work=out.get("work", 0)))
                if drops:
                    held = keep_two(units, held, draw)
            if t1 - t_win >= seconds:
                break
        window_s = time.perf_counter() - t_win
    if gc_pause is not None:
        gc_pause.close()
    launches = {k: v - launches0.get(k, 0)
                for k, v in port.launch_counts().items()}
    spans = port.stop_tracing(tracer) if tracer is not None else None
    sut.read_back(units)
    peak = (torch.cuda.max_memory_allocated()
            if device.startswith("cuda") else 0)
    times = [round(u["seconds"], 4) for u in units]
    collected = "" if gc_pause is None else (
        f"; garbage collection "
        f"{sum(b - a for a, b in gc_pause.pauses) / 1e9:.3f} s in "
        f"{len(gc_pause.pauses)}")
    _log(f"window {window_s:.3f} s, {len(units)} units, "
         f"{attempted} points attempted, {failed} failed{collected}; "
         f"launches {launches}; unit seconds "
         f"{times if len(times) <= 20 else times[:20] + ['...']}")

    ref = Reference(config["banks"], config["mshrs"])
    view = RunView(units=units, window_s=window_s, setup_s=setup_s)
    kind = "end_to_end"
    breakdown = None
    if trace:
        kind = "per_layer"
        view.spans = spans
        view.device = dt if dt.events is not None else None
        view.k1_launches = sut.k1_launches(units, spans, ref)
        if view.device is not None:
            breakdown = {"device_ops": dt.top_ops(),
                         "idle_gaps": dt.idle_by_host(
                             spans + gc_pause.spans(epoch_ns), epoch_ns)}
    metrics = {}
    for m in man.metrics(name, kind):
        value = man.reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: read the program's outputs, free its state, then run
    # the reference on the host
    sample = sut.sample(units, ref, seed)
    del units, view, sut
    gc.collect()
    numbers = check.compare(sample, ref)
    control_numbers = (check.compare(sample, ref, float_type=np.float32,
                                     stand_in=True) if control else None)
    correct = check.verdict(numbers) and failed == 0
    found = forbidden_modules()
    if found:
        _log(f"cimbench: the run loaded {found}")
        raise SystemExit(3)

    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and dt.events is not None:
        dev.update(busy_s=dt.busy_s, window_s=dt.window_s)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control_numbers is not None:
        out["control"] = control_numbers
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in numbers.items()}
    for k, v in numbers.items():
        _log(f"check {k} {v} limit {check.LIMITS[k]}")
    return out

