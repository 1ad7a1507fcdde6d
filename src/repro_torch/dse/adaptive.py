"""Adaptive, frontier-driven design-space refinement.

Twin of ``repro/dse/adaptive.py``, over the port's engine.

The paper's DSE figures price full cross-products — fine for the §VI-D/E
grids, hopeless as axes multiply (the 5-axis space is already
``|W|·|C|·|L|·|T|·|H|`` points).  But the question those sweeps answer is
not "what does every point cost"; it is "where is the energy/performance
frontier".  :class:`AdaptiveDSE` exploits that: price a *coarse* seed,
extract the per-workload Pareto frontier, then iteratively re-enumerate
only the **axis neighborhoods** of non-dominated points
(:func:`repro_torch.dse.space.neighborhood`: adjacent cache geometries,
neighboring techs/hosts, CiM-level supersets) — for at most ``max_rounds``
rounds or until the frontier stops moving, whichever comes first.

Three properties make the loop cheap and honest:

  * **Canonical dedup.**  Every candidate is keyed by
    :attr:`~repro_torch.dse.space.SweepPoint.key` (hashable now that
    :class:`~repro_torch.core.host_model.HostModel` is) and priced at most once
    per run, however many frontier neighborhoods propose it.
  * **Warm rounds.**  Rounds price through one
    :class:`~repro_torch.dse.engine.DSEEngine`, so the layered
    :class:`~repro_torch.dse.engine.AnalysisCache` /
    :class:`~repro_torch.dse.store.AnalysisStore` stack applies: a refinement
    round over an already-analyzed ``(workload, cache)`` pair does zero
    trace builds, and with a warm persistent store *every* round does.
  * **Finite frontiers.**  :func:`~repro_torch.dse.pareto.pareto_front`
    excludes non-finite objective values, so one degenerate record can never steer
    refinement into garbage regions.

Usage::

    from repro_torch.dse import AdaptiveDSE, SweepSpace

    full = SweepSpace(workloads=("KM", "BFS"),
                      caches=("32K+256K", "64K+256K", "64K+2M"),
                      cim_levels=("L1_only", "L2_only", "both"),
                      techs=("sram", "fefet"))
    adaptive = AdaptiveDSE(full).run()        # default coarse seed
    print(adaptive.summary())
    for rec in adaptive.frontier:
        print(rec.config_label)

``adaptive.results`` is an ordinary merged
:class:`~repro_torch.dse.results.SweepResults` (each record's ``round`` column
says which refinement round priced it), so all existing reporting works
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, Iterator, List, Optional, Sequence, Set, Tuple,
                    Union)

from repro_torch import obs
from repro_torch.dse.engine import DSEEngine
from repro_torch.dse.pareto import Objective, frontier_stable
from repro_torch.dse.results import SweepRecord, SweepResults
from repro_torch.dse.space import SweepPoint, SweepSpace, neighborhood


def coarse_seed(space: SweepSpace) -> List[SweepPoint]:
    """Default seed for :class:`AdaptiveDSE`: the cheapest corner of the
    cross-product from which every point of ``space`` is reachable by
    neighborhood moves.

    All workloads (frontiers are per-workload — every workload needs a
    starting point), the space's *first* cache geometry / tech / CiM-set /
    host / TPU option (adjacency walks reach the rest), and the space's
    minimal CiM level sets (every level set not strictly containing
    another — level moves only go up, so the seed must start at the bottom
    of the superset lattice)."""
    level_tuples = space._level_tuples()
    minimal = [lv for lv in level_tuples
               if not any(set(other) < set(lv) for other in level_tuples)]
    points: List[SweepPoint] = []
    for w in space.workloads:
        for lv in minimal:
            points.append(SweepPoint(
                index=len(points), workload=w, cache=space.caches[0],
                cim_levels=lv, tech=space.techs[0],
                cim_set=space.cim_sets[0], host=space.hosts[0],
                tpu=space.tpus[0]))
    return points


@dataclasses.dataclass(frozen=True)
class RoundInfo:
    """Cost/effect accounting of one refinement round."""
    round: int                 # 0 = coarse seed
    n_candidates: int          # points proposed (seed size / neighborhoods)
    n_priced: int              # survived dedup and were actually priced
    frontier_size: int         # per-workload frontier after this round
    stable: bool               # frontier unchanged vs the previous round
    stats: Dict[str, int]      # this round's engine counter deltas
    elapsed_s: float


@dataclasses.dataclass(frozen=True)
class RoundEvent:
    """One completed refinement round, emitted as it lands.

    The incremental unit of :meth:`AdaptiveDSE.run_iter` — everything a
    streaming consumer (the DSE service's NDJSON responses, a progress
    bar) needs to report the round without waiting for the run to finish:
    the round's cost accounting, the frontier *after* the round, and the
    merged results so far.  ``results`` is the same accumulating object a
    final :class:`AdaptiveResult` wraps, not a copy.
    """
    info: RoundInfo
    frontier: List[SweepRecord]       # per-workload frontier after the round
    results: SweepResults             # merged results through this round


@dataclasses.dataclass
class AdaptiveResult:
    """Everything one adaptive run produced."""
    results: SweepResults             # all priced points, rounds merged
    rounds: List[RoundInfo]
    frontier: List[SweepRecord]       # final per-workload Pareto frontier
    objectives: Tuple[Objective, ...]
    space_size: int                   # |full cross-product|

    @property
    def n_priced(self) -> int:
        return len(self.results)

    @property
    def savings(self) -> float:
        """How many times fewer points than the full cross-product."""
        return self.space_size / max(1, self.n_priced)

    def summary(self) -> str:
        lines = [f"adaptive DSE: {self.n_priced}/{self.space_size} points "
                 f"priced ({self.savings:.1f}x fewer), "
                 f"{len(self.rounds)} rounds, "
                 f"frontier size {len(self.frontier)}"]
        for r in self.rounds:
            lines.append(
                f"  round {r.round}: {r.n_priced}/{r.n_candidates} new "
                f"points, frontier {r.frontier_size}, "
                f"trace_builds {r.stats.get('trace_builds', 0)}, "
                f"{r.elapsed_s:.2f}s"
                + (" [stable]" if r.stable else ""))
        return "\n".join(lines)

    def to_markdown(self) -> str:
        """Merged multi-round report (adds the round-provenance column)."""
        return self.results.to_markdown(
            columns=("workload", "cache", "cim_levels", "tech", "host",
                     "round", "energy_improvement", "speedup"),
            pareto_objectives=self.objectives)


class AdaptiveDSE:
    """Frontier-driven iterative refinement over a :class:`SweepSpace`.

    ``space`` is the design *universe*: refinement only ever prices points
    whose axis values appear in it, so the result is always comparable to
    (and typically a small subset of) the exhaustive ``space.points()``
    sweep.  ``engine`` defaults to a fresh thread-pool
    :class:`~repro_torch.dse.engine.DSEEngine`; pass one with a ``store`` to
    make rounds nearly free on warm artifacts.  ``max_rounds`` bounds the
    refinement rounds *after* the seed; the loop also stops as soon as the
    frontier is stable across a round (same design points, by
    :attr:`~repro_torch.dse.space.SweepPoint.key`) or a round proposes nothing
    new.
    """

    def __init__(self, space: SweepSpace,
                 engine: Optional[DSEEngine] = None,
                 objectives: Sequence[Objective] = ("energy_improvement",
                                                    "speedup"),
                 max_rounds: int = 8):
        if max_rounds < 0:
            raise ValueError("max_rounds must be >= 0")
        self.space = space
        self.engine = engine or DSEEngine()
        self.objectives = tuple(objectives)
        self.max_rounds = max_rounds
        # per-axis membership of the declared design universe — O(1) checks
        # without materializing the cross-product this module exists to
        # avoid (the grid is only ever *counted*, via len(space))
        self._axis_values = (
            frozenset(space.workloads),
            frozenset(c.levels for c in space.caches),
            frozenset(space._level_tuples()),
            frozenset(space.techs),
            frozenset(space.cim_sets),
            frozenset(space.hosts),
            frozenset(space.tpus),
        )

    # ------------------------------------------------------------ helpers
    def _in_space(self, p: SweepPoint) -> bool:
        w, caches, levels, techs, sets_, hosts, tpus = self._axis_values
        return (p.workload in w and p.cache.levels in caches
                and p.cim_levels in levels and p.tech in techs
                and p.cim_set in sets_ and p.host in hosts
                and p.tpu in tpus)

    def _dedup(self, candidates: Sequence[SweepPoint],
               seen: Set[Tuple]) -> List[SweepPoint]:
        """In-universe candidates not yet priced, analysis-key-grouped
        (adjacent points share trace artifacts / process-pool chunks) with
        first-seen order preserved within a group."""
        groups: Dict[Tuple, List[SweepPoint]] = {}
        for p in candidates:
            if p.key in seen or not self._in_space(p):
                continue
            seen.add(p.key)
            groups.setdefault(p.analysis_key, []).append(p)
        return [p for group in groups.values() for p in group]

    # ---------------------------------------------------------------- run
    def run(self, seed: Optional[Union[SweepSpace, Sequence[SweepPoint]]]
            = None) -> AdaptiveResult:
        """Seed → price → frontier → refine loop.

        ``seed`` may be a coarse :class:`SweepSpace`, an explicit point
        list, or ``None`` for :func:`coarse_seed`.  Drains
        :meth:`run_iter` — streaming consumers iterate that directly and
        get each round as it completes."""
        rounds: List[RoundInfo] = []
        last: Optional[RoundEvent] = None
        for event in self.run_iter(seed):
            rounds.append(event.info)
            last = event
        if last is None:                       # empty seed
            return AdaptiveResult(results=SweepResults(records=[]),
                                  rounds=[], frontier=[],
                                  objectives=self.objectives,
                                  space_size=len(self.space))
        return AdaptiveResult(results=last.results, rounds=rounds,
                              frontier=last.frontier,
                              objectives=self.objectives,
                              space_size=len(self.space))

    def run_iter(self, seed: Optional[Union[SweepSpace,
                                            Sequence[SweepPoint]]] = None
                 ) -> Iterator[RoundEvent]:
        """Generator form of :meth:`run`: yield a :class:`RoundEvent` the
        moment each refinement round's pricing completes — the DSE
        service streams these as NDJSON lines while later rounds are
        still running.  Same loop, same stopping rules, same records."""
        if seed is None:
            candidates: List[SweepPoint] = coarse_seed(self.space)
        elif isinstance(seed, SweepSpace):
            candidates = seed.points()
        else:
            candidates = list(seed)

        outside = [p for p in candidates if not self._in_space(p)]
        if outside:
            raise ValueError(
                f"{len(outside)} seed point(s) lie outside the design "
                f"space (e.g. {outside[0].label!r}); every seed axis value "
                f"must appear in the AdaptiveDSE space — silently dropping "
                f"them would shrink coverage with no warning")

        seen: Set[Tuple] = set()
        priced_points: List[SweepPoint] = []   # aligned with merged records
        merged: Optional[SweepResults] = None
        prev_frontier: Optional[List[SweepRecord]] = None

        for rnd in range(self.max_rounds + 1):
            fresh = self._dedup(candidates, seen)
            if not fresh:
                break                          # nothing new to explore
            # the span closes before the yield: a generator must not hold
            # an open span across a suspension (the consumer's own spans
            # would nest under it and the contextvar reset would cross
            # frames), so each round is traced as a closed unit
            with obs.span("adaptive.round", cat="adaptive", round=rnd,
                          n_candidates=len(candidates),
                          n_fresh=len(fresh)) as rsp:
                res = self.engine.run(fresh)
                res = SweepResults(
                    records=[dataclasses.replace(r, round=rnd)
                             for r in res.records],
                    stats=res.stats, elapsed_s=res.elapsed_s)
                merged = res if merged is None else merged.merge(res)
                priced_points.extend(fresh)

                frontier = merged.pareto(self.objectives)
                # design identity, not objective values: two designs that
                # price identically still count as frontier movement
                stable = frontier_stable(
                    prev_frontier, frontier, self.objectives,
                    key=lambda r: priced_points[r.index].key)
                rsp.set(frontier_size=len(frontier), stable=stable)
            yield RoundEvent(
                info=RoundInfo(
                    round=rnd, n_candidates=len(candidates),
                    n_priced=len(fresh), frontier_size=len(frontier),
                    stable=stable, stats=res.stats,
                    elapsed_s=res.elapsed_s),
                frontier=frontier, results=merged)
            if stable:
                break
            prev_frontier = frontier
            candidates = [nb for rec in frontier
                          for nb in neighborhood(priced_points[rec.index],
                                                 self.space)]
