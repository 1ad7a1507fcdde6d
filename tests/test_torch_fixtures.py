"""The port's trace fixtures against fresh reference traces.

``src/repro_torch/workloads/fixtures/`` is the oracle the port's trace VM
is held to where jax is absent: one ``<NAME>.npz`` per Table-IV workload (the
reference's structural columns in its layer-1 ``.npz`` encoding, the
program outputs, and ``meta_*`` versions) and ``reference_reports.json``
(the reference's numpy-backend reports for every fig14 geometry x fig15
level set x fig16 technology, with the replay counters).

It also writes ``reference_single_pass.json``: the reference's
single-pass Algorithm 1 (``OffloadConfig(require_same_bank=True)`` and
``OffloadConfig(allow_cross_level=False, cim_levels=("L1",))``) on the 17
workloads at 32K+256K, priced in SRAM and FeFET, and the lines that
``examples/quickstart.py`` and ``examples/evaluate_workloads.py`` print.

This file is the one generator of all three.  Rerun it after a
``TRACE_VM_VERSION`` or ``ANALYSIS_VERSION`` bump in the reference, or any
change to the reference's workloads, selection, pricing or examples::

    PYTHONPATH=src python tests/test_torch_fixtures.py --regenerate
    PYTHONPATH=src python tests/test_torch_fixtures.py --regenerate single_pass

(the second form writes ``reference_single_pass.json`` alone).

The tests hold each committed fixture to a fresh reference run:
``trace_structural`` column for column, and the single-pass records and
example lines.  Both depend on how the installed jax lowers each workload,
so those comparisons skip when the running jax is not the one that wrote
the fixtures.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib
import sys

import jax
import numpy as np
import pytest

from repro.core import accel
from repro.core.cache import CacheConfig as RefCacheConfig
from repro.core.offload import ANALYSIS_VERSION
from repro.core.offload import OffloadConfig as RefOffloadConfig
from repro.core.offload import select_candidates as ref_select
from repro.core.profiler import profile_system as ref_profile
from repro.core.reshape import reshape as ref_reshape
from repro.core.trace import (TRACE_VM_VERSION, attach_cache_results,
                              trace_structural)
from repro.workloads import WORKLOADS as REF_WORKLOADS
from repro.workloads import build

pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch.core import offload as port_offload
from repro_torch.core import trace as port_trace
from repro_torch.workloads import fixtures


def ref_geometry(levels):
    """A port cache geometry as the reference's configs (by field)."""
    return tuple(RefCacheConfig(**dataclasses.asdict(c)) for c in levels)


def fixture_arrays(name):
    """A fresh reference trace of ``name`` in the fixture layout."""
    fn, args = build(name)
    st = trace_structural(fn, *args)
    arrays = st.columns.to_arrays()
    for i, out in enumerate(st.outputs):
        arrays[f"out_{i}"] = np.asarray(out)
    arrays["meta_n_outputs"] = np.asarray([len(st.outputs)], np.int64)
    arrays["meta_trace_vm_version"] = np.asarray([TRACE_VM_VERSION],
                                                 np.int64)
    arrays["meta_analysis_version"] = np.asarray([ANALYSIS_VERSION],
                                                 np.int64)
    arrays["meta_jax_version"] = np.asarray(jax.__version__)
    arrays["meta_n_instructions"] = np.asarray([st.n_instructions],
                                               np.int64)
    return st, arrays


def reference_points(st):
    """The reference's numpy-backend records and counters for one
    workload, in the order of the port engine's design-point space
    (:func:`fixtures.design_point_space`: cache, then level set, then
    technology)."""
    records, counters = [], {}
    with accel.use_backend("numpy"):
        for cache, levels in fixtures.CACHES.items():
            tr = attach_cache_results(st, ref_geometry(levels))
            counters[cache] = tr.cache.counters()
            for lv_name, cim_levels in fixtures.LEVEL_SETS.items():
                cfg = RefOffloadConfig(cim_levels=cim_levels)
                res = ref_select(tr.trace, cfg=cfg)
                shaped = ref_reshape(tr.trace, res)
                for tech in fixtures.TECHS:
                    rep = ref_profile(tr, cfg, tech, offload=res,
                                      reshaped=shaped)
                    records.append({"cache": cache, "cim_levels": lv_name,
                                    "tech": tech,
                                    **fixtures.report_record(rep)})
    return records, counters


EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def reference_example(name: str, argv=None, workloads=None) -> str:
    """What ``examples/<name>.py`` of the reference prints, run in
    process; ``workloads`` narrows its loop over the Table-IV programs."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if workloads is not None:
        mod.WORKLOADS = tuple(workloads)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv) if argv is not None else mod.main()
    assert rc == 0
    return buf.getvalue()


def reference_single_pass_records(name):
    """The reference's single-pass records of one workload: a fresh trace
    at :data:`fixtures.SINGLE_PASS_CACHE`, each of
    :data:`fixtures.SINGLE_PASS_CONFIGS`, priced per technology."""
    fn, args = build(name)
    levels = fixtures.CACHES[fixtures.SINGLE_PASS_CACHE]
    records = []
    with accel.use_backend("numpy"):
        tr = attach_cache_results(trace_structural(fn, *args),
                                  ref_geometry(levels))
        for config, kw in fixtures.SINGLE_PASS_CONFIGS.items():
            cfg = RefOffloadConfig(**kw)
            res = ref_select(tr.trace, cfg=cfg)
            shaped = ref_reshape(tr.trace, res)
            reports = {tech: ref_profile(tr, cfg, tech, offload=res,
                                         reshaped=shaped)
                       for tech in fixtures.TECHS}
            records += fixtures.single_pass_records(name, config, res,
                                                    reports)
    return records


def regenerate_single_pass():
    doc = {"meta": {"jax_version": jax.__version__,
                    "trace_vm_version": TRACE_VM_VERSION,
                    "analysis_version": ANALYSIS_VERSION,
                    "cache": fixtures.SINGLE_PASS_CACHE,
                    "configs": {k: {f: list(v) if isinstance(v, tuple)
                                    else v for f, v in kw.items()}
                                for k, kw in
                                fixtures.SINGLE_PASS_CONFIGS.items()}},
           "records": [],
           "examples": {"quickstart": fixtures.example_lines(
               reference_example("quickstart")),
               "evaluate_workloads": {}}}
    for name in fixtures.WORKLOADS:
        doc["records"] += reference_single_pass_records(name)
        print(f"{name}: single pass recorded")
    for tech in fixtures.TECHS:
        doc["examples"]["evaluate_workloads"][tech] = fixtures.example_lines(
            reference_example("evaluate_workloads", ["--tech", tech]))
    fixtures.SINGLE_PASS_PATH.write_text(json.dumps(doc, indent=1) + "\n")


def regenerate():
    fixtures.FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    reports = {"meta": {"trace_vm_version": TRACE_VM_VERSION,
                        "analysis_version": ANALYSIS_VERSION,
                        "jax_version": jax.__version__,
                        "backend": "numpy"},
               "workloads": {}}
    for name in fixtures.WORKLOADS:
        st, arrays = fixture_arrays(name)
        np.savez_compressed(fixtures.FIXTURE_DIR / f"{name}.npz", **arrays)
        records, counters = reference_points(st)
        reports["workloads"][name] = {"records": records,
                                      "counters": counters}
        print(f"{name}: {st.n_instructions} instructions, "
              f"{len(records)} records")
    fixtures.REPORTS_PATH.write_text(json.dumps(reports, indent=1) + "\n")
    regenerate_single_pass()


# ======================================================================
# tests
# ======================================================================
def test_workload_vocabulary_matches_reference():
    assert tuple(REF_WORKLOADS) == fixtures.WORKLOADS
    from repro.workloads import CATEGORY
    assert CATEGORY == fixtures.CATEGORY


def test_fixture_versions_match_reference_and_port():
    """The fixtures, the port and the reference agree on the trace-VM and
    analysis versions (a reference bump means: regenerate)."""
    assert port_trace.TRACE_VM_VERSION == TRACE_VM_VERSION
    assert port_offload.ANALYSIS_VERSION == ANALYSIS_VERSION
    meta = fixtures.reference_reports()["meta"]
    assert meta["trace_vm_version"] == TRACE_VM_VERSION
    assert meta["analysis_version"] == ANALYSIS_VERSION
    for name in fixtures.WORKLOADS:
        arrays = fixtures.load_arrays(name)
        assert int(arrays["meta_trace_vm_version"][0]) == TRACE_VM_VERSION
        assert int(arrays["meta_analysis_version"][0]) == ANALYSIS_VERSION
        assert int(arrays["meta_n_instructions"][0]) == \
            len(arrays["col_op"])
        assert str(arrays["meta_jax_version"]) == meta["jax_version"]


@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_fixture_equals_fresh_trace(name):
    committed = fixtures.load_arrays(name)
    written_by = str(committed["meta_jax_version"])
    if written_by != jax.__version__:
        pytest.skip(f"fixtures were traced under jax {written_by}; this "
                    f"is jax {jax.__version__}, which may lower the "
                    "workloads differently")
    _, fresh = fixture_arrays(name)
    assert sorted(fresh) == sorted(committed)
    for key, arr in fresh.items():
        assert committed[key].dtype == arr.dtype, key
        assert np.array_equal(committed[key], arr), key


def _skip_unless_written_by_this_jax(written_by):
    if written_by != jax.__version__:
        pytest.skip(f"the fixture was written under jax {written_by}; this "
                    f"is jax {jax.__version__}, which may lower the "
                    "workloads differently")


@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_single_pass_fixture_equals_fresh_reference(name):
    """The committed single-pass records of one workload, and its line of
    ``examples/evaluate_workloads.py`` in each technology, against a fresh
    reference run."""
    committed = fixtures.reference_single_pass()
    _skip_unless_written_by_this_jax(committed["meta"]["jax_version"])
    want = [r for r in committed["records"] if r["workload"] == name]
    assert len(want) == len(fixtures.SINGLE_PASS_CONFIGS) \
        * len(fixtures.TECHS)
    assert reference_single_pass_records(name) == want
    for tech in fixtures.TECHS:
        lines = committed["examples"]["evaluate_workloads"][tech]
        mine = [lines[0]] + [ln for ln in lines[1:]
                             if ln.split()[0] == name]
        assert fixtures.example_lines(reference_example(
            "evaluate_workloads", ["--tech", tech], workloads=[name])) \
            == mine


def test_single_pass_fixture_quickstart_equals_fresh_reference():
    committed = fixtures.reference_single_pass()
    _skip_unless_written_by_this_jax(committed["meta"]["jax_version"])
    assert len(committed["records"]) == 68
    assert fixtures.example_lines(reference_example("quickstart")) == \
        committed["examples"]["quickstart"]


if __name__ == "__main__":
    if sys.argv[1:2] != ["--regenerate"] or \
            sys.argv[2:] not in ([], ["single_pass"]):
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_fixtures.py "
                 "--regenerate [single_pass]")
    if sys.argv[2:] == ["single_pass"]:
        regenerate_single_pass()
    else:
        regenerate()
