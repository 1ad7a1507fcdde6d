"""Pareto-frontier extraction over arbitrary objectives.

Twin of ``repro/dse/pareto.py`` (stdlib only, a straight port).

The DSE engine's reporting question — "which design points are *worth*
anything?" — is multi-objective: the paper trades energy improvement
against speedup (and, implicitly, area/technology).  A point is kept iff
no other point is at least as good on every objective and strictly better
on one (:func:`dominates` over sign-normalized vectors).

Works on any records (dataclasses, dicts, plain objects): objectives are
named attributes/keys, each maximized by default or minimized when given
as ``(name, "min")``.  Output is deterministic — input order is preserved
— and duplicate-valued points are all kept (they dominate each other
weakly but strictly dominate nothing).

Non-finite objective values (NaN, ±inf) are **excluded** from every
frontier: NaN compares false both ways, so a degenerate record would
otherwise sit on every frontier forever (it neither dominates nor is
dominated), and an ``inf`` record would flush everything else off it.
Either failure mode poisons frontier-driven refinement
(:mod:`repro_torch.dse.adaptive`), which prices the *neighborhoods* of frontier
points — so a frontier may only ever contain fully finite records.

Usage::

    from repro_torch.dse import pareto_front

    front = pareto_front(results.records,
                         ("energy_improvement", "speedup"))
    cheap = pareto_front(rows, (("cim_energy_pj", "min"), "speedup"))

:meth:`repro_torch.dse.results.SweepResults.pareto` wraps this per-workload (a
KM design point should not dominate a BFS one).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

Objective = Union[str, Tuple[str, str]]


@functools.lru_cache(maxsize=256)
def _parse_cached(objectives: Tuple[Objective, ...]
                  ) -> Tuple[Tuple[str, float], ...]:
    out = []
    for o in objectives:
        if isinstance(o, str):
            out.append((o, 1.0))
        else:
            name, direction = o
            if direction not in ("max", "min"):
                raise ValueError(f"objective direction must be 'max' or "
                                 f"'min', got {direction!r}")
            out.append((name, 1.0 if direction == "max" else -1.0))
    if not out:
        raise ValueError("need at least one objective")
    return tuple(out)


def _parse(objectives: Sequence[Objective]) -> Tuple[Tuple[str, float], ...]:
    """Normalized (name, sign) pairs — memoized, so per-item callers of
    :func:`objective_vector` don't re-validate the objective spec each
    time.  Non-str entries pass through whole so the cached parser's
    2-unpack still rejects malformed arities like ("cost", "min", "?")."""
    return _parse_cached(tuple(o if isinstance(o, str) else tuple(o)
                               for o in objectives))


def _value(item: Any, name: str) -> float:
    if isinstance(item, dict):
        return float(item[name])
    return float(getattr(item, name))


def _signed(item: Any, parsed: Sequence[Tuple[str, float]]
            ) -> Tuple[float, ...]:
    return tuple(sign * _value(item, name) for name, sign in parsed)


def objective_vector(item: Any, objectives: Sequence[Objective]
                     ) -> Tuple[float, ...]:
    """Signed objective values (higher is always better after signing)."""
    return _signed(item, _parse(objectives))


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff signed-vector ``a`` Pareto-dominates ``b`` (>= everywhere,
    > somewhere)."""
    return all(x >= y for x, y in zip(a, b)) and any(x > y
                                                     for x, y in zip(a, b))


def pareto_front(items: Sequence[Any],
                 objectives: Sequence[Objective] = ("energy_improvement",
                                                    "speedup")) -> List[Any]:
    """Non-dominated subset of ``items``, in input order.

    Records with any non-finite objective value (NaN, ±inf) are dropped
    before the scan — they can neither appear on the frontier nor dominate
    anything off it (see the module docstring for why).

    O(n^2) pairwise scan — sweep result sets are hundreds of points, not
    millions, and the simple scan keeps ties/duplicates handling obvious.
    """
    parsed = _parse(objectives)
    pool = [(it, vec) for it in items
            for vec in (_signed(it, parsed),)
            if all(math.isfinite(x) for x in vec)]
    out = []
    for i, (item, vi) in enumerate(pool):
        if not any(dominates(vj, vi)
                   for j, (_, vj) in enumerate(pool) if j != i):
            out.append(item)
    return out


def frontier_stable(prev: Optional[Sequence[Any]], new: Sequence[Any],
                    objectives: Sequence[Objective] = ("energy_improvement",
                                                       "speedup"),
                    key: Optional[Callable[[Any], Any]] = None) -> bool:
    """Termination predicate for frontier-driven refinement.

    True iff ``new`` is the same frontier as ``prev``: identical multisets
    of signed objective vectors, or identical ``key(item)`` sets when a
    ``key`` is given (use a design-point identity key to distinguish two
    different designs that happen to price identically).  ``prev=None``
    (no earlier round) is never stable.
    """
    if prev is None:
        return False
    if key is not None:
        return {key(it) for it in prev} == {key(it) for it in new}
    parsed = _parse(objectives)
    return (sorted(_signed(it, parsed) for it in prev)
            == sorted(_signed(it, parsed) for it in new))
