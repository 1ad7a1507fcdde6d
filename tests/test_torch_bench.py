"""The port's paper artifacts against the reference's.

``python -m repro_torch.bench --device cpu`` writes the ten artifacts
(table3/5, fig12–17, table6, fig_adaptive), each of which must be byte for
byte the CSV and JSON that ``python -m benchmarks.run`` writes.  The card
may have no jax, so the reference's artifacts and its full sweep records
are committed under ``src/repro_torch/workloads/fixtures/
reference_artifacts/`` (see :mod:`repro_torch.workloads.fixtures`); this
file is their one generator::

    PYTHONPATH=src python tests/test_torch_bench.py --regenerate

It runs the reference's drivers in-process on the numpy path, with their
``emit`` pointed at the fixture directory, so nothing is written under
``benchmarks/``.  While jax is present the tests also hold the port to a
fresh in-process reference run on the committed traces.
"""
import contextlib
import importlib
import io
import json
import pathlib
import sys

import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch.bench import run as port_run
from repro_torch.dse import AdaptiveDSE, DSEEngine
from repro_torch.workloads import fixtures

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _benchmarks(module):
    """The reference's ``benchmarks.<module>``."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"benchmarks.{module}")


def _ref_driver(name):
    """The reference's driver module of artifact ``name``."""
    return _benchmarks(port_run.stem(name))


def _round(info):
    return {"round": info.round, "n_candidates": info.n_candidates,
            "n_priced": info.n_priced, "frontier_size": info.frontier_size,
            "stable": info.stable}


def sweep_doc(spaces, engine, adaptive_cls, objectives):
    """Full records of each sweep space, and the adaptive run on
    fig_adaptive's space, as plain JSON-able dicts."""
    doc = {name: [r.to_dict() for r in engine.run(space)]
           for name, space in spaces.items()}
    ad = adaptive_cls(spaces["fig_adaptive"], engine=engine,
                      objectives=objectives).run()
    doc["adaptive"] = {"records": [r.to_dict() for r in ad.results],
                       "frontier": [r.to_dict() for r in ad.frontier],
                       "rounds": [_round(r) for r in ad.rounds]}
    return doc


def reference_artifacts(out_dir, traces=contextlib.nullcontext):
    """Run the reference's ten drivers in-process, numpy path, one fresh
    engine, their artifacts written to ``out_dir``; ``traces`` may swap
    the engine's source of structural traces."""
    from repro.core import accel
    common = _benchmarks("common")
    saved = common.ART, common._ENGINE
    common.ART, common._ENGINE = pathlib.Path(out_dir), None
    try:
        with accel.use_backend("numpy"), traces(), \
                contextlib.redirect_stdout(io.StringIO()):
            for name in port_run.CIM:
                _ref_driver(name).main()
    finally:
        common.ART, common._ENGINE = saved


def reference_sweeps(traces=contextlib.nullcontext):
    """The reference's records (numpy path) of the five sweep spaces, as
    its drivers build them; ``traces`` as in :func:`reference_artifacts`."""
    from repro.core import accel
    from repro.dse import AdaptiveDSE as RefAdaptive
    from repro.dse import DSEEngine as RefEngine
    from repro.dse import SweepSpace as RefSpace
    from repro.workloads import WORKLOADS as REF_WORKLOADS
    benches = _benchmarks("common").SWEEP_BENCHES
    f14, f15, f17, fa = (_ref_driver(n) for n in
                         ("fig14", "fig15", "fig17", "fig_adaptive"))
    spaces = {
        "fig14": RefSpace(workloads=benches, caches=f14.CFG_NAMES),
        "fig15": RefSpace(workloads=benches, cim_levels=f15.LEVEL_NAMES),
        "fig16": RefSpace(workloads=tuple(REF_WORKLOADS),
                          techs=("sram", "fefet")),
        "fig17": RefSpace(workloads=benches, hosts=f17.HOSTS),
        "fig_adaptive": RefSpace(workloads=fa.WORKLOADS, caches=fa.CACHES,
                                 cim_levels=fa.LEVELS, techs=fa.TECHS,
                                 hosts=fa.HOSTS),
    }
    with accel.use_backend("numpy"), traces():
        return sweep_doc(spaces, RefEngine(), RefAdaptive, fa.OBJECTIVES)


def port_sweeps(device="cpu"):
    """The port's records of the same five spaces (its drivers'
    ``space()``) on ``device``."""
    from repro_torch.bench import fig_adaptive
    spaces = {name: port_run.ALL[name].space()
              for name in port_run.SWEEPS}
    return sweep_doc(spaces, DSEEngine(device=device), AdaptiveDSE,
                     fig_adaptive.OBJECTIVES)


def regenerate():
    sys.dont_write_bytecode = True     # nothing lands under benchmarks/
    fixtures.ARTIFACTS_DIR.mkdir(parents=True, exist_ok=True)
    reference_artifacts(fixtures.ARTIFACTS_DIR)
    fixtures.RECORDS_PATH.write_text(json.dumps(reference_sweeps()) + "\n")
    for p in sorted(fixtures.ARTIFACTS_DIR.iterdir()):
        print(f"{p.name}: {p.stat().st_size} bytes")


# ======================================================================
# tests
# ======================================================================
def _files(stem):
    return (f"{stem}.csv", f"{stem}.json")


@pytest.fixture(scope="module")
def port_artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_artifacts")
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_run.main(["--device", "cpu", "--out", str(out),
                              *port_run.CIM]) == 0
    return out


@pytest.fixture(scope="module")
def fresh_reference_artifacts(tmp_path_factory):
    pytest.importorskip("jax")
    from test_torch_dse import reference_on_fixtures
    out = tmp_path_factory.mktemp("reference_artifacts")
    reference_artifacts(out, reference_on_fixtures)
    return out


@pytest.fixture(scope="module")
def port_records():
    return port_sweeps("cpu")


@pytest.mark.parametrize("name", port_run.CIM)
def test_artifact_equals_committed_reference(port_artifacts, name):
    for fname in _files(port_run.stem(name)):
        assert (port_artifacts / fname).read_bytes() == \
            (fixtures.ARTIFACTS_DIR / fname).read_bytes(), fname


@pytest.mark.parametrize("name", port_run.CIM)
def test_artifact_equals_fresh_reference_run(port_artifacts,
                                             fresh_reference_artifacts,
                                             name):
    for fname in _files(port_run.stem(name)):
        assert (port_artifacts / fname).read_bytes() == \
            (fresh_reference_artifacts / fname).read_bytes(), fname


@pytest.mark.parametrize("name", port_run.SWEEPS)
def test_sweep_records_equal_committed_reference(port_records, name):
    want = fixtures.reference_records()[name]
    assert len(port_records[name]) == len(want)
    assert port_records[name] == want


def test_adaptive_run_equals_committed_reference(port_records):
    want = fixtures.reference_records()["adaptive"]
    got = port_records["adaptive"]
    assert got["rounds"] == want["rounds"]
    assert got["frontier"] == want["frontier"]
    assert got["records"] == want["records"]


def test_committed_records_equal_fresh_reference_run():
    pytest.importorskip("jax")
    from test_torch_dse import reference_on_fixtures
    assert json.loads(json.dumps(reference_sweeps(reference_on_fixtures))) == \
        fixtures.reference_records()


def test_committed_artifacts_are_the_reference_drivers_names():
    names = sorted(p.name for p in fixtures.ARTIFACTS_DIR.iterdir())
    assert names == sorted([*(f for name in port_run.CIM
                              for f in _files(port_run.stem(name))),
                            "records.json"])
    assert port_run.SWEEPS == ("fig14", "fig15", "fig16", "fig17",
                               "fig_adaptive")
    for name in port_run.ALL:
        assert callable(_ref_driver(name).main)


def test_runner_lists_artifacts_and_rejects_unknown_names(capsys):
    assert port_run.main(["--list"]) == 0
    listed = [line.split()[0] for line in
              capsys.readouterr().out.strip().splitlines()]
    assert listed == ["table3", "table5", "fig12", "fig13", "table6",
                      "fig14", "fig15", "fig16", "fig17", "fig_adaptive",
                      "tpu_macr", "fig_tpu_dse"]
    assert port_run.main(["--device", "cpu", "fig99"]) == 1
    assert "unknown benchmark 'fig99'" in capsys.readouterr().out


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_bench.py "
                 "--regenerate")
    regenerate()
