"""The port's trace fixtures against fresh reference traces.

``src/repro_torch/workloads/fixtures/`` is the oracle the port's trace VM
is held to where jax is absent: one ``<NAME>.npz`` per Table-IV workload (the
reference's structural columns in its layer-1 ``.npz`` encoding, the
program outputs, and ``meta_*`` versions) and ``reference_reports.json``
(the reference's numpy-backend reports for every fig14 geometry x fig15
level set x fig16 technology, with the replay counters).

This file is the one generator of both.  Rerun it after a
``TRACE_VM_VERSION`` or ``ANALYSIS_VERSION`` bump in the reference, or any
change to the reference's workloads or pricing::

    PYTHONPATH=src python tests/test_torch_fixtures.py --regenerate

The tests hold each committed fixture to a fresh ``trace_structural``,
column for column.  The traces depend on how the installed jax lowers each
workload, so those comparisons skip when the running jax is not the one
that wrote the fixtures.
"""
import dataclasses
import json
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
    workload, in :func:`fixtures.price_design_points` order."""
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


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_fixtures.py "
                 "--regenerate")
    regenerate()
