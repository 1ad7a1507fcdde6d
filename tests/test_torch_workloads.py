"""The 17 Table-IV workloads in torch against the reference's: the same
inputs, the port VM's columns ``==`` the reference VM's and the committed
fixture's, the outputs equal to eager ``fn(*args)`` and to the reference;
twins of ``tests/test_workloads.py``; and the DSE engine tracing them."""
import ast
import builtins
import hashlib
import inspect
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

from repro.core.trace import trace_structural as ref_trace_structural
from repro.workloads import WORKLOADS as REF_WORKLOADS
from repro.workloads import build as ref_build
from repro_torch.core import OffloadConfig, profile_system
from repro_torch.core.trace import trace_program, trace_structural
from repro_torch.dse import store as port_store
from repro_torch.dse.engine import AnalysisCache
from repro_torch.dse.space import CacheOption
from repro_torch.workloads import CATEGORY, WORKLOADS, build, fixtures

NAMES = sorted(WORKLOADS)


def test_workload_vocabulary_matches_reference():
    from repro.workloads import CATEGORY as REF_CATEGORY
    assert list(WORKLOADS) == list(REF_WORKLOADS)
    assert CATEGORY == REF_CATEGORY
    assert tuple(WORKLOADS) == fixtures.WORKLOADS


@pytest.mark.parametrize("name", NAMES)
def test_workload_traces_the_reference_columns(name):
    ref_fn, ref_args = ref_build(name)
    fn, args = build(name)
    # the inputs are the reference's, dtype and all
    assert len(args) == len(ref_args)
    for a, r in zip(args, ref_args):
        r = np.asarray(r)
        assert a.numpy().dtype == r.dtype and a.shape == r.shape
        np.testing.assert_array_equal(a.numpy(), r)
    st = trace_structural(fn, *args, device="cpu")
    ref = ref_trace_structural(ref_fn, *ref_args)
    have = st.columns.to_arrays()
    want = ref.columns.to_arrays()
    fix = fixtures.load_arrays(name)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
        np.testing.assert_array_equal(have[k], fix[k], err_msg=k)
    # outputs: the reference VM's, the fixture's, eager torch's
    eager = torch.utils._pytree.tree_leaves(fn(*args))
    assert len(st.outputs) == len(ref.outputs) == len(eager)
    for i, (g, w, e) in enumerate(zip(st.outputs, ref.outputs, eager)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        for other in (w, fix[f"out_{i}"], e.numpy()):
            np.testing.assert_allclose(g.numpy(), other, rtol=1e-4, atol=1e-4)
    # the program's inputs are untouched by the run
    for a, r in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


# ------------------------------------------------ twins of test_workloads
@pytest.mark.parametrize("name", ["LCS", "SSSP", "DT", "mcf"])
def test_workload_profile_in_range(name):
    fn, args = build(name)
    tr = trace_program(fn, *args, device="cpu")
    rep = profile_system(tr, OffloadConfig(), device="cpu")
    assert 0.0 < rep.macr <= 1.0
    assert 0.5 < rep.energy_improvement < 10.0
    assert 0.5 < rep.speedup < 3.0
    assert np.isfinite(rep.base.total) and np.isfinite(rep.cim.total)


def test_lcs_is_cim_favorable():
    """Section VI-A validation workload: LCS must clear the MACR >= 0.5 bar."""
    fn, args = build("LCS")
    rep = profile_system(trace_program(fn, *args, device="cpu"),
                         OffloadConfig(), device="cpu")
    assert rep.cim_favorable


@pytest.mark.parametrize("name", ["LCS", "DT"])
def test_workload_scales_like_the_reference(name):
    """``scale`` grows the inputs as the reference's builders do."""
    fn, args = build(name, scale=2)
    ref_fn, ref_args = ref_build(name, scale=2)
    for a, r in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    st = trace_structural(fn, *args, device="cpu")
    ref = ref_trace_structural(ref_fn, *ref_args)
    assert st.n_instructions == ref.n_instructions
    np.testing.assert_array_equal(st.columns.to_arrays()["col_addr"],
                                  ref.columns.to_arrays()["col_addr"])


# --------------------------------------------------- the engine on the VM
def test_analysis_cache_never_opens_a_fixture():
    opened = []
    real_open, real_load = builtins.open, np.load

    def spy_open(file, *a, **kw):
        opened.append(str(file))
        return real_open(file, *a, **kw)

    def spy_load(file, *a, **kw):
        opened.append(str(file))
        return real_load(file, *a, **kw)

    cache = AnalysisCache(device="cpu")
    with mock.patch("builtins.open", spy_open), \
            mock.patch.object(np, "load", spy_load), \
            mock.patch.object(fixtures, "load_arrays",
                              side_effect=AssertionError("fixture read")), \
            mock.patch.object(fixtures, "load_structural",
                              side_effect=AssertionError("fixture read")):
        tr = cache.trace("DFS", CacheOption.of("32K+256K"))
    fixture_dir = str(fixtures.FIXTURE_DIR)
    assert not [p for p in opened if p.startswith(fixture_dir)]
    np.testing.assert_array_equal(tr.trace.to_arrays()["col_addr"],
                                  fixtures.load_arrays("DFS")["col_addr"])
    assert cache.trace_builds == 1


def test_workload_fingerprint_follows_the_module_source(monkeypatch):
    monkeypatch.setattr(port_store, "_FINGERPRINTS", {})
    src = inspect.getsource(inspect.getmodule(WORKLOADS["NB"]))
    want = hashlib.sha256(f"NB\n{src}".encode()).hexdigest()[:16]
    assert port_store.workload_fingerprint("NB") == want
    # NB and KM share a module; the name keeps them apart
    assert port_store.workload_fingerprint("KM") != want
    # an edit of the program's module is a new fingerprint
    monkeypatch.setattr(port_store, "_FINGERPRINTS", {})
    monkeypatch.setattr(port_store.inspect, "getsource",
                        lambda mod: src + "\n# edited\n")
    assert port_store.workload_fingerprint("NB") != want
    # an unknown workload degrades to its name
    monkeypatch.setattr(port_store, "_FINGERPRINTS", {})
    assert port_store.workload_fingerprint("nope") == hashlib.sha256(
        b"nope\n").hexdigest()[:16]


def test_workload_modules_use_no_graph_capture():
    root = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch"
    banned = ("torch.export", "torch.compile", "make_fx", "_higher_order_ops")
    # the lint names these APIs as the capture points its jit-purity
    # checker looks for; it imports no torch at all, checked below
    lint = root / "lint"
    hits = [f"{f.relative_to(root)}: {b}"
            for f in sorted(root.rglob("*.py")) if lint not in f.parents
            for b in banned if b in f.read_text()]
    assert hits == []
    lint_imports = [f"{f.relative_to(root)}: {name}"
                    for f in sorted(lint.rglob("*.py"))
                    for node in ast.walk(ast.parse(f.read_text()))
                    if isinstance(node, (ast.Import, ast.ImportFrom))
                    for name in ([a.name for a in node.names]
                                 if isinstance(node, ast.Import)
                                 else [node.module or ""])
                    if name.split(".")[0] == "torch"]
    assert len(list(lint.rglob("*.py"))) >= 8 and lint_imports == []


def test_traces_on_concurrent_threads_stay_apart():
    """The engine's thread pool traces workloads side by side: each
    thread's dispatch mode sees only its own program's ops."""
    import sys
    import threading

    names = ["DFS", "LCS", "mcf", "KM", "hmmer", "DT", "SVM", "BC",
             "SSSP", "NB", "PRANK", "M2D"]
    results, errors = {}, []

    def work(name):
        try:
            fn, args = build(name)
            results[name] = trace_structural(fn, *args, device="cpu")
        except Exception as e:              # reported below
            errors.append((name, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(n,)) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for name in names:
        have = results[name].columns.to_arrays()
        want = fixtures.load_arrays(name)
        for k in have:
            np.testing.assert_array_equal(have[k], want[k], err_msg=name)
