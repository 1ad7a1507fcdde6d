"""The kinds of configuration: ``cimbench/kinds/<kind>.py`` builds,
drives and checks every configuration whose file says ``"kind": "<kind>"``
(``"cim"`` where it says nothing).  :func:`cimbench.bench.run_cell` keeps
what every kind shares; a kind's module gives what differs:

``build_kernels() -> {source: seconds}``
    compile what the checkout's build directory lacks (on the card only);
``traffic(path, config, seed)``
    the run's traffic from the mix at ``path``: an object whose
    ``units()`` yields, without end, dicts with ``"points"``, the list of
    what a unit counts as attempted (design points);
``port(traffic, config, device)``
    the system under test, an object with ``warm() -> int`` (set-up,
    the points warmed), ``run_unit(unit) -> dict`` (the unit's outputs,
    with ``"work"`` where a rate counts more than points),
    ``release(unit)`` (drop what a unit holds, where the window keeps it
    no longer), ``read_back(units)``
    (once the window has closed), ``traced_fields(units, spans, ref) ->
    dict`` (attributes a traced run's :class:`cimbench.bench.RunView`
    gains for the kind's readers) and ``sample(units, ref, seed)`` (the
    outputs the check compares, drawn from ``seed``);
``keeps_every_unit(traffic) -> bool``
    whether the window holds every unit's state, or the last and one
    drawn (:func:`cimbench.bench.keep_two`);
``reference(config)``
    the plain reference, which imports nothing of the program;
``compare(sample, ref) -> {name: number}``, ``LIMITS``
    the numbers compared and their limits: a run is correct where every
    number is at most its limit and no unit failed;
``control(sample, ref) -> {name: number}``
    the same numbers with the reference, one precision down, in the
    program's place: they have to fail;
``tiny_config(config)``, ``tiny_mix(mix)``
    the cut that ``cimbench/tests/cimbench_tiny.py`` makes for a CPU run;
``FAULTS``, ``fault(name)``
    the faults of the timed path the check has to catch, and a context
    manager that plants one (``"none"`` plants nothing).
"""
from __future__ import annotations

import importlib
import pathlib
from typing import List

HERE = pathlib.Path(__file__).resolve().parent
DEFAULT = "cim"


def known() -> List[str]:
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def load(kind: str):
    """The module of ``kind``; raises ``ValueError`` naming the known
    kinds where there is none."""
    if kind not in known():
        raise ValueError(f"unknown configuration kind {kind!r}; known "
                         f"kinds: {', '.join(known())}")
    return importlib.import_module(f"cimbench.kinds.{kind}")


def of(config) -> object:
    """The module of the kind that ``config`` (a configuration file's
    object) names."""
    return load(config.get("kind", DEFAULT))
