"""Typed sweep specification: the cross-product of the paper's design axes.

Twin of ``repro/dse/space.py``: the same axes, presets, enumeration order,
labels and keys, the accelerator-mode ``tpus`` axis included.  A CiM
point's ``key`` is the reference's without its trailing ``tpu`` (``None``
on every CiM point); an accelerator-mode point's is the reference's.

Eva-CiM's design space (§VI-D/E, Figs. 14–16) spans five orthogonal axes:

  * **workload**   — which benchmark program (Table IV),
  * **cache**      — L1/L2 geometry (Fig. 14's three configurations),
  * **cim_levels** — which cache levels host the CiM arrays (Fig. 15),
  * **tech**       — the device technology, SRAM vs FeFET (Fig. 16 /
                     Table III), plus the supported-op set it implies,
  * **host**       — the host-CPU model the CiM arrays are attached to
                     (§V-C/§VI-D host/CiM interaction; named presets in
                     :data:`repro_torch.core.host_model.HOST_PRESETS`).

A :class:`SweepSpace` enumerates the full cross-product as a deterministic,
stable-ordered list of :class:`SweepPoint` records (workload-major, so all
points sharing one expensive trace analysis are adjacent).  Each point can
mint its own :class:`~repro_torch.core.offload.OffloadConfig` for the selection
phase; everything else on the point — tech *and* host — is pricing-phase
input, so neither axis ever adds analysis work.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch.core.cache import (CacheConfig, L1_32K, L1_64K, L2_256K,
                                    L2_2M)
from repro_torch.core.device_model import TECHS
from repro_torch.core.host_model import HOST_PRESETS, HostModel
from repro_torch.core.isa import CIM_SET_FULL, CIM_SET_LOGIC, CIM_SET_STT
from repro_torch.core.offload import OffloadConfig
from repro_torch.core.tpu_model import TPU_PRESETS, TpuChip

# Named presets for the paper's swept values ---------------------------------
CACHE_PRESETS: Dict[str, Tuple[CacheConfig, ...]] = {
    "32K+256K": (L1_32K, L2_256K),
    "64K+256K": (L1_64K, L2_256K),
    "64K+2M": (L1_64K, L2_2M),
}
LEVEL_PRESETS: Dict[str, Tuple[str, ...]] = {
    "L1_only": ("L1",),
    "L2_only": ("L2",),
    "both": ("L1", "L2"),
}
CIM_SETS = {
    "logic": CIM_SET_LOGIC,
    "stt": CIM_SET_STT,
    "full": CIM_SET_FULL,
}

DEFAULT_CACHE = "32K+256K"       # trace_program's default (L1_32K, L2_256K)


@dataclasses.dataclass(frozen=True)
class CacheOption:
    """One named cache configuration (hierarchy geometry)."""
    name: str
    levels: Tuple[CacheConfig, ...]

    @classmethod
    def of(cls, spec: Union[str, "CacheOption", Tuple[CacheConfig, ...]]
           ) -> "CacheOption":
        if isinstance(spec, CacheOption):
            return spec
        if isinstance(spec, str):
            if spec not in CACHE_PRESETS:
                raise KeyError(f"unknown cache preset {spec!r}; "
                               f"known: {sorted(CACHE_PRESETS)}")
            return cls(spec, CACHE_PRESETS[spec])
        levels = tuple(spec)

        def size_name(c: CacheConfig) -> str:
            mb = 1024 * 1024
            return f"{c.size // mb}M" if c.size >= mb else f"{c.size // 1024}K"

        return cls("+".join(size_name(c) for c in levels), levels)


@dataclasses.dataclass(frozen=True)
class HostOption:
    """One named host-CPU configuration (pricing-phase axis value)."""
    name: str
    model: HostModel

    @classmethod
    def of(cls, spec: Union[str, "HostOption", HostModel]) -> "HostOption":
        if isinstance(spec, HostOption):
            return spec
        if isinstance(spec, HostModel):
            # a hand-built model may carry a preset's (default) name with
            # different constants — label it distinctly so records/reports
            # never conflate it with the real preset
            name = (spec.name if HOST_PRESETS.get(spec.name) == spec
                    else f"custom({spec.name})")
            return cls(name, spec)
        if spec not in HOST_PRESETS:
            raise KeyError(f"unknown host preset {spec!r}; "
                           f"known: {sorted(HOST_PRESETS)}")
        return cls(spec, HOST_PRESETS[spec])


def _fmt_bytes(n: int) -> str:
    """Compact power-of-two-ish byte label: 65536 -> '64K', 2**20 -> '1M'."""
    if n >= 1 << 20 and n % (1 << 20) == 0:
        return f"{n >> 20}M"
    if n >= 1 << 10 and n % (1 << 10) == 0:
        return f"{n >> 10}K"
    return str(n)


def parse_bytes(spec: Union[str, int]) -> int:
    """Inverse of the label format: '64K' -> 65536, '1M' -> 2**20, 4096 -> 4096."""
    if isinstance(spec, int):
        return spec
    s = spec.strip().upper()
    for suffix, shift in (("M", 20), ("K", 10)):
        if s.endswith(suffix):
            return int(s[:-1]) << shift
    return int(s)


@dataclasses.dataclass(frozen=True)
class TpuOption:
    """One TPU-mode hardware/fusion configuration (the backend-specific axis).

    The TPU analogue of the (cache geometry, cim_levels, tech) bundle: which
    chip the step is priced on, how aggressive VMEM fusion is (a candidate
    chain is only realized when it eliminates at least ``min_saved_bytes`` of
    HBM traffic), and optional what-if scaling of the two memory-system
    resources (``vmem_scale`` gates which candidates *fit*, a selection-phase
    input; ``hbm_bw_scale`` moves the roofline, a pricing-phase input).
    Frozen + hashable so TPU-carrying :class:`SweepPoint` dedup works.
    """
    chip: TpuChip
    min_saved_bytes: int = 1 << 16
    vmem_scale: float = 1.0
    hbm_bw_scale: float = 1.0

    @property
    def chip_label(self) -> str:
        base = next((k for k, v in TPU_PRESETS.items() if v == self.chip),
                    self.chip.name)
        if self.vmem_scale != 1.0:
            base += f"*vmem{self.vmem_scale:g}"
        if self.hbm_bw_scale != 1.0:
            base += f"*bw{self.hbm_bw_scale:g}"
        return base

    @property
    def threshold_label(self) -> str:
        return f"thr{_fmt_bytes(self.min_saved_bytes)}"

    @property
    def name(self) -> str:
        return f"{self.chip_label}/{self.threshold_label}"

    def effective_chip(self) -> TpuChip:
        """The chip with the what-if scalings applied (pricing input)."""
        if self.vmem_scale == 1.0 and self.hbm_bw_scale == 1.0:
            return self.chip
        return dataclasses.replace(
            self.chip, vmem_bytes=self.chip.vmem_bytes * self.vmem_scale,
            hbm_bw=self.chip.hbm_bw * self.hbm_bw_scale)

    @classmethod
    def of(cls, spec: Union[str, "TpuOption", TpuChip]) -> "TpuOption":
        if isinstance(spec, TpuOption):
            return spec
        if isinstance(spec, TpuChip):
            return cls(chip=spec)
        if spec not in TPU_PRESETS:
            raise KeyError(f"unknown TPU chip preset {spec!r}; "
                           f"known: {sorted(TPU_PRESETS)}")
        return cls(chip=TPU_PRESETS[spec])


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One fully-specified design point of the sweep."""
    index: int                       # position in the deterministic ordering
    workload: str
    cache: CacheOption
    cim_levels: Tuple[str, ...]
    tech: str
    cim_set: str = "stt"
    host: Optional[HostOption] = None    # None: the engine's default host
    tpu: Optional[TpuOption] = None      # None: CiM point (the default)

    @property
    def analysis_key(self) -> Tuple:
        """Key of the config-independent phase this point can reuse.

        Keyed by the full cache geometry (not the display name): two
        options with equal sizes but different associativity/banking must
        not share a memoized trace.  Accelerator-mode points share one
        graph analysis per workload regardless of the (unused) CiM cache
        axis."""
        if self.tpu is not None:
            return (self.workload, "tpu")
        return (self.workload, self.cache.levels)

    @property
    def key(self) -> Tuple:
        """Canonical design identity — everything that affects pricing,
        *excluding* ``index`` (a point's position differs between the
        coarse sweep and a refinement round, but it is the same design)
        and the cache display name (geometry is the identity, two
        differently-labeled options with equal geometry price alike).
        This is the dedup key of adaptive refinement: a point is priced at
        most once per :class:`~repro_torch.dse.adaptive.AdaptiveDSE` run
        however many neighborhoods propose it.  A CiM point's key ends
        before the reference's trailing ``tpu`` (``None`` there)."""
        key = (self.workload, self.cache.levels, self.cim_levels,
               self.tech, self.cim_set,
               None if self.host is None else (self.host.name,
                                               self.host.model))
        return key if self.tpu is None else key + (self.tpu,)

    @property
    def label(self) -> str:
        if self.tpu is not None:
            return f"{self.workload}/{self.tpu.name}"
        lv = "+".join(self.cim_levels)
        base = (f"{self.workload}/{self.cache.name}/cim@{lv}"
                f"/{self.tech}/{self.cim_set}")
        return base if self.host is None else f"{base}/{self.host.name}"

    def offload_config(self) -> OffloadConfig:
        return OffloadConfig(cim_set=CIM_SETS[self.cim_set],
                             cim_levels=self.cim_levels)


@dataclasses.dataclass(frozen=True)
class SweepSpace:
    """Cross-product specification over the four design axes.

    Axis values accept preset *names* (strings) wherever one exists, so the
    common sweeps read like the paper:

        SweepSpace(workloads=("KM", "BFS"),
                   caches=("32K+256K", "64K+2M"),
                   cim_levels=("L1_only", "both"),
                   techs=("sram", "fefet"),
                   hosts=("A9-1GHz", "inorder-1GHz", "big-OoO-2GHz"))

    The ``hosts`` default of ``(None,)`` means "price with the engine's
    default host" — existing four-axis sweeps enumerate identically.
    """
    workloads: Tuple[str, ...]
    caches: Tuple[Union[str, CacheOption], ...] = (DEFAULT_CACHE,)
    cim_levels: Tuple[Union[str, Tuple[str, ...]], ...] = ("both",)
    techs: Tuple[str, ...] = ("sram",)
    cim_sets: Tuple[str, ...] = ("stt",)
    hosts: Tuple[Union[str, HostOption, HostModel, None], ...] = (None,)
    # backend-specific axis: accelerator-mode chip/threshold options (None
    # = CiM point priced by the engine's backend default).  CiM sweeps
    # leave it at (None,) and enumerate identically to the five-axis form.
    tpus: Tuple[Union[str, TpuOption, TpuChip, None], ...] = (None,)

    def __post_init__(self):
        for t in self.techs:
            if t not in TECHS:
                raise KeyError(f"unknown tech {t!r}; known: {sorted(TECHS)}")
        for s in self.cim_sets:
            if s not in CIM_SETS:
                raise KeyError(f"unknown CiM op set {s!r}; "
                               f"known: {sorted(CIM_SETS)}")
        for lv in self._level_tuples():
            for name in lv:
                if name not in ("L1", "L2"):
                    raise KeyError(f"unknown cache level {name!r}")
        # materialize options eagerly so bad names fail at build time
        object.__setattr__(self, "caches",
                           tuple(CacheOption.of(c) for c in self.caches))
        object.__setattr__(self, "hosts",
                           tuple(None if h is None else HostOption.of(h)
                                 for h in self.hosts))
        object.__setattr__(self, "tpus",
                           tuple(None if t is None else TpuOption.of(t)
                                 for t in self.tpus))

    # ------------------------------------------------------------ helpers
    def _level_tuples(self) -> List[Tuple[str, ...]]:
        out = []
        for lv in self.cim_levels:
            if isinstance(lv, str):
                if lv not in LEVEL_PRESETS:
                    raise KeyError(f"unknown level preset {lv!r}; "
                                   f"known: {sorted(LEVEL_PRESETS)}")
                out.append(LEVEL_PRESETS[lv])
            else:
                out.append(tuple(lv))
        return out

    def __len__(self) -> int:
        return (len(self.workloads) * len(self.caches)
                * len(self.cim_levels) * len(self.techs)
                * len(self.cim_sets) * len(self.hosts) * len(self.tpus))

    def points(self) -> List[SweepPoint]:
        """Deterministic enumeration, workload-major then cache — all points
        sharing one trace analysis are contiguous.  The host and TPU axes
        iterate innermost: host is pricing-only and every TPU option of one
        workload shares one graph analysis, so variants of one design point
        stay adjacent and reuse every cached artifact."""
        levels = self._level_tuples()
        out: List[SweepPoint] = []
        for w, cache, lv, tech, cs, host, tpu in itertools.product(
                self.workloads, self.caches, levels, self.techs,
                self.cim_sets, self.hosts, self.tpus):
            out.append(SweepPoint(index=len(out), workload=w, cache=cache,
                                  cim_levels=lv, tech=tech, cim_set=cs,
                                  host=host, tpu=tpu))
        return out

    def __iter__(self) -> Iterator[SweepPoint]:
        return iter(self.points())

    def n_analyses(self) -> int:
        """Number of expensive trace/IDG passes the sweep needs (vs
        ``len(self)`` full pipeline runs without memoization)."""
        return len(self.workloads) * len(self.caches)


# ---------------------------------------------------------------------------
# Axis neighborhoods — the refinement move set of adaptive DSE.
# ---------------------------------------------------------------------------
def _adjacent(ordered: Sequence, i: int) -> List:
    out = []
    if i > 0:
        out.append(ordered[i - 1])
    if 0 <= i < len(ordered) - 1:
        out.append(ordered[i + 1])
    return out


def neighborhood(point: SweepPoint, space: SweepSpace) -> List[SweepPoint]:
    """Single-axis neighbors of ``point`` within ``space``'s axis values.

    The move set deliberately mirrors how the axes order physically:

      * **cache** — the geometries adjacent to the point's in the space's
        ``caches`` ordering (declare them small→large and "adjacent" means
        the next size step, Fig. 14's axis);
      * **cim_levels** — every level set in the space that *strictly
        contains* the point's (supersets only: adding CiM arrays to more
        levels explores monotone extensions of a good placement);
      * **tech / cim_set / host** — the values adjacent in the space's
        declared ordering;
      * **tpu** — backend-aware sub-axis moves: the TPU options in the
        space that keep every other :class:`TpuOption` field and step to
        the *adjacent* chip preset or the adjacent fusion threshold (in
        the order the distinct values are declared) — one knob at a time,
        exactly like the CiM axes.

    Each move changes exactly one axis, so a refinement round prices a
    cross-shaped neighborhood around every frontier point rather than a
    new sub-cross-product.  Points are emitted with ``index=-1`` (the
    driver/engine re-indexes); values outside the space never appear, so
    refinement stays inside the declared design universe.  A point whose
    axis value is not in the space at all contributes no move on that
    axis.
    """
    moves: List[SweepPoint] = []

    def emit(**replacement) -> None:
        moves.append(dataclasses.replace(point, index=-1, **replacement))

    caches: Sequence[CacheOption] = space.caches
    ci = next((i for i, c in enumerate(caches)
               if c.levels == point.cache.levels), -1)
    for c in _adjacent(caches, ci):
        emit(cache=c)

    current = set(point.cim_levels)
    for lv in space._level_tuples():
        if current < set(lv):
            emit(cim_levels=lv)

    for t in _adjacent(space.techs, list(space.techs).index(point.tech)
                       if point.tech in space.techs else -1):
        emit(tech=t)
    for s in _adjacent(space.cim_sets,
                       list(space.cim_sets).index(point.cim_set)
                       if point.cim_set in space.cim_sets else -1):
        emit(cim_set=s)

    hosts: Sequence[Optional[HostOption]] = space.hosts
    hi = next((i for i, h in enumerate(hosts) if h == point.host), -1)
    for h in _adjacent(hosts, hi):
        emit(host=h)

    for t in tpu_neighbors(point.tpu, space.tpus):
        emit(tpu=t)
    return moves


def tpu_neighbors(current: Optional[TpuOption],
                  declared: Sequence[Optional[TpuOption]]
                  ) -> List[TpuOption]:
    """Single-knob TPU moves: options in ``declared`` reached from
    ``current`` by stepping exactly one sub-axis — the adjacent chip preset
    or the adjacent ``min_saved_bytes`` threshold (each sub-axis ordered by
    first appearance in the declared options, mirroring the other axes'
    declared-order adjacency).  Only declared options are ever returned, so
    a sparse (non-grid) TPU axis stays sparse under refinement."""
    if current is None:
        return []
    options = [t for t in declared if t is not None]
    universe = set(options)
    chips = list(dict.fromkeys(t.chip for t in options))
    thresholds = list(dict.fromkeys(t.min_saved_bytes for t in options))
    out: List[TpuOption] = []
    ci = chips.index(current.chip) if current.chip in chips else -1
    for chip in _adjacent(chips, ci):
        cand = dataclasses.replace(current, chip=chip)
        if cand in universe:
            out.append(cand)
    ti = (thresholds.index(current.min_saved_bytes)
          if current.min_saved_bytes in thresholds else -1)
    for thr in _adjacent(thresholds, ti):
        cand = dataclasses.replace(current, min_saved_bytes=thr)
        if cand in universe:
            out.append(cand)
    return out
