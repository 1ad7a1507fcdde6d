"""repro_torch.lint against repro.lint (twin of ``tests/test_lint.py``).

Both packages get the same inputs: the shared plumbing (finding keys,
comment annotations, the baseline), the normalizer on the reference's
fixture sources and on every module of both packages' layers, and each
checker on the reference's synthetic trees, built once in the
reference's layout and once in the port's (``src/repro_torch/``, the
port's test files, ``repro_torch.`` twins).  Findings must be equal with
paths and the texts that name a package mapped.  The port's fingerprint
is one text across interpreters (``fingerprint.dump``, not
``ast.dump``), and the jit-purity checker looks for torch's capture
points; both have cases of their own.  Last, the tree: the port is
lint-clean, its manifest matches it, and ``python -m repro_torch.lint``
runs with torch, numpy, JAX and ``repro`` blocked.
"""
import ast
import copy
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.lint import core as ref_core
from repro.lint import fingerprint as ref_fp
from repro.lint import parity as ref_parity
from repro.lint import threads as ref_threads
from repro.lint import cli as ref_cli

from repro_torch.lint import cli as port_cli
from repro_torch.lint import core as port_core
from repro_torch.lint import fingerprint as port_fp
from repro_torch.lint import parity as port_parity
from repro_torch.lint import threads as port_threads
from repro_torch.lint.jit_purity import check_file as jit_check_file

import test_lint as ref_tests

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_TESTS = ("tests/test_torch_kernels.py", "tests/test_torch_place.py")


def _write(root: pathlib.Path, relpath: str, source: str) -> pathlib.Path:
    path = root / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def _to_port(text: str) -> str:
    """A reference path, message or source as the port states it."""
    return (text.replace("src/repro/", "src/repro_torch/")
            .replace("python -m repro.lint", "python -m repro_torch.lint")
            .replace("repro.core.", "repro_torch.core.")
            .replace("naming its numpy oracle", "naming its plain version")
            .replace("referencing it in tests/test_accel.py",
                     "referencing it in " + " or ".join(PORT_TESTS)))


def _mapped(findings):
    """Reference findings with their paths and messages as the port's."""
    return [port_core.Finding(checker=f.checker, path=_to_port(f.path),
                              line=f.line, message=_to_port(f.message),
                              symbol=f.symbol, severity=f.severity)
            for f in findings]


# ======================================================================
# the shared plumbing
# ======================================================================
_FINDINGS = [
    dict(checker="thread-safety", path="src/x.py", line=3, message="m",
         symbol="Cache.f:hits"),
    dict(checker="accel-parity", path="src/y.py", line=9,
         message="no test", symbol=""),
    dict(checker="jit-purity", path="a/b.py", line=1, message="w",
         symbol="s", severity="warning"),
]


@pytest.mark.parametrize("kw", _FINDINGS)
def test_finding_key_and_render_equal_reference(kw):
    ref, port = ref_core.Finding(**kw), port_core.Finding(**kw)
    assert port.key == ref.key
    assert port.render() == ref.render()


_COMMENTED = (
    's = "# lint: guarded-by(_fake)"\n'
    'y = 1  # lint: guarded-by(_real)\n'
    't = """\n# not a comment\n"""  # lint: disable=thread-safety\n'
    '# lint: numpy-twin(repro_torch.core.cache:CacheHierarchy.replay, '
    'batched)\n'
    'def f(a):  # lint: disable=accel-parity,jit-purity (a reason)\n'
    '    return a  # plain note\n'
    'z = "unterminated\n')


def test_file_comments_equal_reference(tmp_path):
    src = _write(tmp_path, "x.py", _COMMENTED)
    comments = port_core.file_comments(src)
    assert comments == ref_core.file_comments(src)
    assert 1 not in comments and "guarded-by(_real)" in comments[2]


@pytest.mark.parametrize("name,lines", [
    ("guarded-by", range(1, 8)), ("guarded-by", range(1, 2)),
    ("numpy-twin", range(5, 7)), ("numpy-twin", range(6, 7)),
    ("disable", range(1, 10))])
def test_annotation_equals_reference(tmp_path, name, lines):
    comments = port_core.file_comments(_write(tmp_path, "x.py", _COMMENTED))
    assert (port_core.annotation(comments, lines, name)
            == ref_core.annotation(comments, lines, name))


@pytest.mark.parametrize("line,checker", [
    (4, "thread-safety"), (5, "thread-safety"), (6, "thread-safety"),
    (7, "accel-parity"), (7, "jit-purity"), (8, "jit-purity"),
    (9, "accel-parity"), (2, "thread-safety")])
def test_is_disabled_equals_reference(tmp_path, line, checker):
    comments = port_core.file_comments(_write(tmp_path, "x.py", _COMMENTED))
    assert (port_core.is_disabled(comments, line, checker)
            == ref_core.is_disabled(comments, line, checker))


@pytest.mark.parametrize("entry", [
    {"key": "x:y:z", "justification": "  "},
    {"key": "", "justification": "why"},
    {"justification": "why"}, {"key": "x:y:z"}])
def test_baseline_refusal_equals_reference(tmp_path, entry):
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps({"suppressions": [entry]}))
    for core in (ref_core, port_core):
        with pytest.raises(ValueError, match="justification"):
            core.load_baseline(bad)


def test_baseline_round_trip_equals_reference(tmp_path):
    entries = {"thread-safety:a.py:C.f:x": "test-only counter",
               "accel-parity:b.py:g": "external twin"}
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_core.save_baseline(entries, ref_path)
    port_core.save_baseline(entries, port_path)
    assert port_path.read_text() == ref_path.read_text()
    assert port_core.load_baseline(ref_path) == ref_core.load_baseline(
        port_path) == entries
    assert port_core.load_baseline(tmp_path / "absent.json") == {}


def test_committed_baseline_is_empty_like_reference():
    assert port_core.load_baseline() == ref_core.load_baseline() == {}


@pytest.mark.parametrize("only", [("no-such-checker",),
                                  ("thread-safety", "nope")])
def test_runner_rejects_unknown_checker_like_reference(only):
    for core in (ref_core, port_core):
        with pytest.raises(ValueError, match="unknown checker"):
            core.run_checkers(only=only)
    port_core.run_checkers(only=("thread-safety",))   # registered
    assert sorted(port_core.CHECKERS) == sorted(ref_core.CHECKERS)


# ======================================================================
# normalization
# ======================================================================
def _ref_normalize(tree, version_const, symbols):
    """The reference's pipeline of ``layer_fingerprint``, step by step."""
    if symbols:
        tree = ref_fp._select_symbols(tree, symbols)
    tree = ref_fp._drop_assign(tree, version_const)
    return ref_fp._Normalizer().visit(copy.deepcopy(tree))


def _fixture_sources():
    """Every module of the reference's fixture tree, with the version
    constant and symbol filter of the layer it stands in."""
    out = {}
    for layer in ref_fp.LAYERS:
        for mod in layer.modules:
            out[mod] = (layer.version_const, layer.symbols.get(mod))
    return out


def _layer_modules():
    """(path, version constant, symbol filter) of every layer module of
    both packages."""
    out = []
    for fp_mod in (ref_fp, port_fp):
        for layer in fp_mod.LAYERS:
            for mod in layer.modules:
                out.append((mod, layer.version_const,
                            layer.symbols.get(mod)))
    return out


@pytest.mark.parametrize("mod,const,symbols", _layer_modules(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_normalized_layer_module_equals_reference(mod, const, symbols):
    tree = ast.parse((ROOT / mod).read_text())
    port = port_fp.normalize(copy.deepcopy(tree), const, symbols)
    ref = _ref_normalize(copy.deepcopy(tree), const, symbols)
    assert ast.dump(port) == ast.dump(ref)


def test_normalized_fixture_modules_equal_reference(tmp_path):
    root = ref_tests._layer_tree(tmp_path)
    for mod, (const, symbols) in _fixture_sources().items():
        tree = ast.parse((root / mod).read_text())
        assert (ast.dump(port_fp.normalize(copy.deepcopy(tree), const,
                                           symbols))
                == ast.dump(_ref_normalize(copy.deepcopy(tree), const,
                                           symbols))), mod


def test_dump_skips_empty_and_none_fields_only():
    tree = ast.parse("def f(a, *, b=1):\n    return a[b:]\n")
    text = port_fp.dump(tree)
    assert "type_params" not in text and "lineno" not in text
    assert "returns" not in text               # None
    assert "decorator_list" not in text        # []
    assert "kw_defaults=[Constant(value=1)]" in text
    fn = tree.body[0]
    fn.type_params = []                        # as 3.12 parses it
    assert port_fp.dump(tree) == text
    fn.decorator_list = [ast.Name(id="d", ctx=ast.Load())]
    assert port_fp.dump(tree) != text


# ======================================================================
# version-integrity
# ======================================================================
def _port_layer_tree(tmp_path: pathlib.Path) -> pathlib.Path:
    """The reference's fixture tree in the port's layout, plus the
    lowering helpers the port's trace-vm layer also covers."""
    ref_root = ref_tests._layer_tree(tmp_path / "ref")
    root = tmp_path / "port"
    shutil.copytree(ref_root / "src" / "repro",
                    root / "src" / "repro_torch")
    _write(root, "src/repro_torch/workloads/lowering.py",
           "def lower(x):\n    return x\n")
    return root


def _edit(root, relpath, *pairs):
    path = root / relpath
    text = path.read_text()
    for old, new in pairs:
        assert old in text
        text = text.replace(old, new)
    path.write_text(text)


_OFFLOAD = "src/repro/core/offload.py"
_BACKENDS = "src/repro/dse/backends.py"
_VERSION_CASES = {
    "clean": [],
    "change_without_bump": [(_OFFLOAD, ("max(levels)", "min(levels)"))],
    "bump_without_update": [(_OFFLOAD, ("max(levels)", "min(levels)"),
                             ("ANALYSIS_VERSION = 2",
                              "ANALYSIS_VERSION = 3"))],
    "renames_docstrings_comments": [(_OFFLOAD, (
        "depth_cap", "depth_ceiling"), ('"""Selection stub."""',
                                        '"""Rewritten docstring."""\n'
                                        '# new comment'))],
    "cim_edit_outside_tpu_filter": [(_BACKENDS, (
        "return point\n\nclass TpuCandidate",
        "return point * 2\n\nclass TpuCandidate"))],
    "tpu_edit_inside_filter": [(_BACKENDS, (
        "def arch_fingerprint(workload):\n    return workload",
        "def arch_fingerprint(workload):\n    return workload * 2"))],
    "store_stats_outside_filter": [(
        "src/repro/dse/store.py", ("return {}", "return {'n': 1}"))],
}


@pytest.mark.parametrize("case", sorted(_VERSION_CASES))
def test_version_integrity_equals_reference(tmp_path, case):
    ref_root = ref_tests._layer_tree(tmp_path / "a")
    port_root = _port_layer_tree(tmp_path / "b")
    ref_man, port_man = tmp_path / "ref.json", tmp_path / "port.json"
    ref_fp.save_manifest(ref_root, ref_man)
    port_fp.save_manifest(port_root, port_man)
    for relpath, *pairs in _VERSION_CASES[case]:
        _edit(ref_root, relpath, *pairs)
        _edit(port_root, _to_port(relpath), *pairs)
    ref = ref_fp.check_versions(ref_root, manifest_path=ref_man)
    port = port_fp.check_versions(port_root, manifest_path=port_man)
    assert port == _mapped(ref)
    expect = {"clean": [], "renames_docstrings_comments": [],
              "cim_edit_outside_tpu_filter": [],
              "store_stats_outside_filter": [],
              "change_without_bump": ["analysis"],
              "bump_without_update": ["analysis"],
              "tpu_edit_inside_filter": ["tpu-analysis"]}[case]
    assert [f.symbol for f in port] == expect
    if case == "bump_without_update":
        assert "--update-manifest" in port[0].message
        port_fp.save_manifest(port_root, port_man)
        ref_fp.save_manifest(ref_root, ref_man)
        assert port_fp.check_versions(port_root, manifest_path=port_man) \
            == ref_fp.check_versions(ref_root, manifest_path=ref_man) == []


def test_missing_manifest_and_layer_equal_reference(tmp_path):
    ref_root = ref_tests._layer_tree(tmp_path / "a")
    port_root = _port_layer_tree(tmp_path / "b")
    absent = tmp_path / "absent.json"
    ref = ref_fp.check_versions(ref_root, manifest_path=absent)
    port = port_fp.check_versions(port_root, manifest_path=absent)
    assert port == _mapped(ref) and port[0].symbol == "<manifest>"
    ref_man, port_man = tmp_path / "ref.json", tmp_path / "port.json"
    for fp_mod, root, man in ((ref_fp, ref_root, ref_man),
                              (port_fp, port_root, port_man)):
        layers = fp_mod.compute_manifest(root)
        del layers["sampling"]
        man.write_text(json.dumps({"format": 1, "layers": layers}))
    ref = ref_fp.check_versions(ref_root, manifest_path=ref_man)
    port = port_fp.check_versions(port_root, manifest_path=port_man)
    assert port == _mapped(ref) and [f.symbol for f in port] == ["sampling"]


def test_lowering_edit_flags_the_trace_vm_layer(tmp_path):
    """The port's trace-vm layer covers ``workloads/lowering.py``, whose
    helpers emit every workload's instructions; the reference has no
    such module."""
    root = _port_layer_tree(tmp_path)
    man = tmp_path / "port.json"
    port_fp.save_manifest(root, man)
    _edit(root, "src/repro_torch/workloads/lowering.py",
          ("return x", "return x + 1"))
    found = port_fp.check_versions(root, manifest_path=man)
    assert [f.symbol for f in found] == ["trace-vm"]
    assert "TRACE_VM_VERSION" in found[0].message


def test_layers_mirror_reference():
    """Same layers, constants and symbol filters; the port's modules are
    the reference's under ``src/repro_torch/``, plus the lowering; the
    same versions but the accelerator-mode analysis's, one ahead (the
    port's recorded step runs on weights drawn from a seed and can record
    a configuration at its published widths)."""
    assert [layer.name for layer in port_fp.LAYERS] == \
        [layer.name for layer in ref_fp.LAYERS]
    for ref, port in zip(ref_fp.LAYERS, port_fp.LAYERS):
        assert port.version_const == ref.version_const
        assert port.version_module == _to_port(ref.version_module)
        extra = (("src/repro_torch/workloads/lowering.py",)
                 if ref.name == "trace-vm" else ())
        assert port.modules == tuple(map(_to_port, ref.modules)) + extra
        assert port.symbols == {_to_port(k): v
                                for k, v in ref.symbols.items()}
        ahead = 1 if ref.name == "tpu-analysis" else 0
        assert (port_fp.read_version(port, ROOT)
                == ref_fp.read_version(ref, ROOT) + ahead)


def test_one_fingerprint_across_interpreters():
    """The same manifest under Python 3.11 as under this interpreter."""
    other = shutil.which("python3.11")
    if other is None:
        pytest.skip("no python3.11 on PATH")
    script = ("import json, pathlib, sys\n"
              "from repro_torch.lint.fingerprint import compute_manifest\n"
              "root = pathlib.Path(sys.argv[1])\n"
              "print(json.dumps({'version': list(sys.version_info[:2]),\n"
              "                  'layers': compute_manifest(root)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([other, "-c", script, str(ROOT)], cwd=ROOT,
                          env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["version"] == [3, 11]
    assert doc["layers"] == port_fp.compute_manifest(ROOT)


# ======================================================================
# thread-safety (the reference's cases, tests/test_lint.py:273-447)
# ======================================================================
_THREAD_CASES = {
    "unguarded_writes": '''
        import threading


        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = 0          # lint: guarded-by(_lock)
                self._memo = {}        # lint: guarded-by(_lock)

            def lookup(self, key):
                self.hits += 1                 # unguarded AugAssign
                self._memo[key] = 1            # unguarded subscript store
                self._memo.setdefault(key, 2)  # unguarded mutation call
                with self._lock:
                    fut = lambda: None

                def deferred():
                    self.hits = 0              # closure: lock not proven
                return deferred
    ''',
    "guarded_writes_and_init": '''
        import threading


        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = 0      # lint: guarded-by(_lock)
                self._memo = {}    # lint: guarded-by(_lock)
                self.hits = 1      # __init__ is exempt

            def lookup(self, key):
                with self._lock:
                    self.hits += 1
                    self._memo[key] = 1
                    if key:
                        self._memo.pop(key, None)
                local = {}
                local["x"] = 1     # locals are out of scope
                return local
    ''',
    "abba_lock_order": '''
        import threading


        class TwoLocks:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self.x = 0    # lint: guarded-by(_a)

            def path1(self):
                with self._a:
                    with self._b:
                        self.x = 1

            def path2(self):
                with self._b:
                    with self._a:
                        self.x = 2
    ''',
    "disable_comment": '''
        import threading


        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = 0  # lint: guarded-by(_lock)

            def reset_unpublished(self):
                self.hits = 0  # lint: disable=thread-safety
    ''',
    "racy_counter": '''
        import threading


        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = 0  # lint: guarded-by(_lock)

            def racy(self):
                self.hits += 1
    ''',
    "setattr_and_delete": '''
        import threading


        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self._memo = {}  # lint: guarded-by(_lock)

            def drop(self, key):
                del self._memo[key]
                setattr(self, "x", 1)
                try:
                    self._memo.clear()
                finally:
                    with self._lock:
                        self._memo.update({})
    ''',
}
_THREAD_COUNTS = {"unguarded_writes": 4, "guarded_writes_and_init": 0,
                  "abba_lock_order": 1, "disable_comment": 0,
                  "racy_counter": 1, "setattr_and_delete": 3}


def _trees(tmp_path, relpath, source):
    ref = tmp_path / "ref"
    port = tmp_path / "port"
    _write(ref, relpath, source)
    _write(port, _to_port(relpath), _to_port(textwrap.dedent(source)))
    return ref, port


@pytest.mark.parametrize("case", sorted(_THREAD_CASES))
@pytest.mark.parametrize("relpath", ["src/repro/dse/engine.py",
                                     "src/repro/dse/service/server.py",
                                     "src/repro/obs/metrics.py"])
def test_thread_safety_equals_reference(tmp_path, case, relpath):
    ref_root, port_root = _trees(tmp_path, relpath, _THREAD_CASES[case])
    ref = ref_threads.check_threads(ref_root)
    port = port_threads.check_threads(port_root)
    assert port == _mapped(ref)
    assert len(port) == _THREAD_COUNTS[case]


def test_thread_safety_skips_unthreaded_paths(tmp_path):
    relpath = "src/repro/core/offload.py"
    ref_root, port_root = _trees(tmp_path, relpath,
                                 _THREAD_CASES["racy_counter"])
    assert port_threads.check_threads(port_root) == \
        ref_threads.check_threads(ref_root) == []


def test_baseline_suppresses_by_stable_key_like_reference(tmp_path):
    ref_root, port_root = _trees(tmp_path, "src/repro/dse/engine.py",
                                 _THREAD_CASES["racy_counter"])
    for core, threads, root in ((ref_core, ref_threads, ref_root),
                                (port_core, port_threads, port_root)):
        found = threads.check_threads(root)
        assert len(found) == 1
        report = core.run_checkers(root=root, only=("thread-safety",),
                                   baseline={found[0].key: "test-only"})
        assert report.ok and report.findings == []
        assert [w for _, w in report.suppressed] == ["test-only"]


def test_threaded_paths_mirror_reference():
    assert port_threads.THREADED == tuple(map(_to_port, ref_threads.THREADED))


# ======================================================================
# accel-parity (the reference's cases)
# ======================================================================
_PARITY_CASES = {
    "missing_annotation": ('''
        def fused_op(a, b):
            return a + b
    ''', "", ""),
    "signature_mismatch_and_missing_test": ('''
        # lint: numpy-twin(repro.core.oracle:fused_ref)
        def fused_op(a, b, out_dtype):
            return a + b
    ''', '''
        def fused_ref(a, b):
            return a + b
    ''', ""),
    "twinned_and_tested": ('''
        # lint: numpy-twin(repro.core.oracle:Hier.fused_ref)
        def fused_op(a, b):
            return a + b


        # lint: numpy-twin(repro.core.oracle:batched_ref, batched)
        def fused_batch(a, b, n_batch):
            return a + b


        def _private_helper(x):
            return x
    ''', '''
        class Hier:
            def fused_ref(self, a, b):
                return a - b


        def batched_ref(a):
            return a
    ''', '''
        def test_fused_op_differential():
            assert fused_op is not None

        def test_fused_batch_differential():
            assert fused_batch is not None
    '''),
    "dangling_twin": ('''
        # lint: numpy-twin(repro.core.oracle:gone)
        def fused_op(a, b):
            return a + b
    ''', "X = 1\n", "fused_op\n"),
    "twin_module_missing": ('''
        # lint: numpy-twin(repro.core.nowhere:f)
        def fused_op(a, b):
            return a + b
    ''', "", "fused_op\n"),
    "twin_is_a_class": ('''
        # lint: numpy-twin(repro.core.oracle:Hier)
        def fused_op(a, b):
            return a + b
    ''', "class Hier:\n    pass\n", "fused_op\n"),
    "external_twin_and_disable": ('''
        # lint: numpy-twin(torch.Tensor.index_add_)
        def fused_op(a, b):
            return a + b


        # lint: disable=accel-parity (launches nothing)
        def word_size(n):
            return 4
    ''', "", "fused_op\n"),
}
_PARITY_COUNTS = {"missing_annotation": 1,
                  "signature_mismatch_and_missing_test": 2,
                  "twinned_and_tested": 0, "dangling_twin": 1,
                  "twin_module_missing": 1, "twin_is_a_class": 1,
                  "external_twin_and_disable": 0}


def _parity_trees(tmp_path, case, port_test):
    accel, oracle, tests = (textwrap.dedent(s) for s in _PARITY_CASES[case])
    ref = ref_tests._parity_tree(tmp_path / "a", accel, oracle, tests)
    port = tmp_path / "b" / "repo"
    _write(port, "src/repro_torch/core/accel/kern.py", _to_port(accel))
    if oracle:
        _write(port, "src/repro_torch/core/oracle.py", oracle)
    _write(port, port_test, tests or "# empty\n")
    return ref, port


@pytest.mark.parametrize("case", sorted(_PARITY_CASES))
@pytest.mark.parametrize("port_test", PORT_TESTS)
def test_accel_parity_equals_reference(tmp_path, case, port_test):
    ref_root, port_root = _parity_trees(tmp_path, case, port_test)
    ref = ref_parity.check_parity(ref_root)
    port = port_parity.check_parity(port_root)
    assert port == _mapped(ref)
    assert len(port) == _PARITY_COUNTS[case]


def test_accel_parity_skips_underscore_modules(tmp_path):
    """``_build.py`` builds kernels and wraps none, like the reference's
    ``__init__.py``; both are skipped."""
    root = tmp_path / "repo"
    for name in ("_build.py", "__init__.py"):
        _write(root, f"src/repro_torch/core/accel/{name}",
               "def build(srcs=None):\n    return {}\n")
    assert port_parity.check_parity(root) == []
    _write(root, "src/repro_torch/core/accel/kern.py",
           "def build(srcs=None):\n    return {}\n")
    assert [f.symbol for f in port_parity.check_parity(root)] == \
        ["build"]


def test_accel_parity_twin_must_be_in_the_port(tmp_path):
    """A twin named in the reference package is not resolved: only
    ``repro_torch.`` targets are checked for existence and signature."""
    root = tmp_path / "repo"
    _write(root, "src/repro_torch/core/accel/kern.py", '''
        # lint: numpy-twin(repro.core.oracle:gone)
        def fused_op(a, b):
            return a + b
    ''')
    _write(root, "tests/test_torch_kernels.py", "fused_op\n")
    assert port_parity.check_parity(root) == []
    _edit(root, "src/repro_torch/core/accel/kern.py",
          ("repro.core", "repro_torch.core"))
    assert [f.symbol for f in port_parity.check_parity(root)] == \
        ["fused_op"]


def test_accel_wrappers_name_their_plain_versions():
    """Every public wrapper of the port's ``core/accel`` is annotated or
    disabled with a reason on the same line."""
    comments = {}
    for path in sorted((ROOT / port_parity.ACCEL_DIR).glob("[!_]*.py")):
        comments.update({(path.name, ln): c for ln, c in
                         port_core.file_comments(path).items()})
    twins = sorted((name, c.split("(", 1)[1].rstrip(")"))
                   for (name, _), c in comments.items()
                   if c.startswith("lint: numpy-twin("))
    assert twins == [
        ("pallas_ops.py", "torch.Tensor.index_add_"),
        ("pallas_ops.py", "torch.Tensor.scatter_reduce_"),
        ("place.py", "repro_torch.core.accel.place:_plain, batched"),
        ("place.py", "repro_torch.core.accel.place:_plain, batched"),
        ("place.py", "repro_torch.core.accel.place:_plain, batched"),
        ("place.py", "repro_torch.core.accel.place:_plain, batched"),
        ("price_counts.py", "repro_torch.core.accel.price_counts:_plain"),
        ("replay.py",
         "repro_torch.core.cache:CacheHierarchy.replay, batched")]
    disabled = sorted(c for c in comments.values()
                      if c.startswith("lint: disable=accel-parity"))
    assert len(disabled) == 2
    assert all(c.split("accel-parity", 1)[1].strip() for c in disabled)


# ======================================================================
# jit-purity (torch's capture points)
# ======================================================================
def test_jit_purity_flags_impure_compiled_bodies(tmp_path):
    path = _write(tmp_path, "src/repro_torch/bad.py", '''
        import functools
        import os
        import time
        import numpy as np
        import torch


        @torch.compile
        def decorated(x, hist=[]):
            hist.append(x)
            return x + time.time()


        @torch.compile(mode="reduce-overhead")
        def synced(x):
            n = x.sum().item()
            return x.tolist(), x.cpu(), x.numpy(), np.asarray(x), n


        def kernel(x):
            if os.environ.get("FLAG"):
                print("tracing")
            return x * np.random.rand()


        @functools.partial(torch.compile, dynamic=False)
        def scripted(x, opts=dict()):
            global STATE
            return x + int(os.environ["N"])


        fn = torch.compile(torch.vmap(functools.partial(kernel)))
        lam = torch.jit.trace(lambda x: print(x), (torch.ones(1),))
    ''')
    found = jit_check_file(path, tmp_path)
    messages = "\n".join(f.message for f in found)
    for fragment in ("mutable default argument", "time.time",
                     ".item() host sync", ".tolist() host sync",
                     ".cpu() host sync", ".numpy() host sync",
                     "np.asarray() on a captured value",
                     "os.environ.get", "print()", "np.random.rand",
                     "`global` statement", "os.environ read",
                     "captured via @torch.compile",
                     "captured via torch.compile(kernel)",
                     "captured via torch.jit.trace(<lambda>)"):
        assert fragment in messages, fragment
    assert {f.symbol.split(":")[0] for f in found} == {
        "decorated", "synced", "kernel", "scripted", "<lambda>"}
    assert all("captured via" in f.message for f in found)


def test_jit_purity_flags_graphed_callables_and_graph_captures(tmp_path):
    path = _write(tmp_path, "src/repro_torch/graphs.py", '''
        import time
        import torch


        def step(x):
            return x * x.max().item()


        def other(x):
            t0 = time.perf_counter()
            return x + t0


        def untouched(x):
            print("never captured")
            return x


        @torch.jit.script
        def scripted(x):
            return x.tolist()


        graphed = torch.cuda.make_graphed_callables((step,), (torch.ones(2),))
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = other(torch.ones(2))
            print("inside the capture")
    ''')
    found = jit_check_file(path, tmp_path)
    by_name = {}
    for f in found:
        by_name.setdefault(f.symbol.split(":")[0], []).append(f.message)
    assert set(by_name) == {"step", "other", "scripted", "<capture>"}
    assert "make_graphed_callables(step)" in by_name["step"][0]
    assert "with torch.cuda.graph(...): other()" in by_name["other"][0]
    assert "print()" in by_name["<capture>"][0]
    assert "@torch.jit.script" in by_name["scripted"][0]


def test_jit_purity_passes_pure_bodies(tmp_path):
    path = _write(tmp_path, "src/repro_torch/good.py", '''
        import os
        import time
        import jax
        import torch

        # effects *outside* the captured body are exactly how it's done
        DEBUG = os.environ.get("DEBUG") == "1"
        t0 = time.time()


        @torch.compile
        def kernel(x, scale=2):
            y = torch.clamp(x, min=0) * scale
            return y.sum()


        @jax.jit
        def not_a_torch_capture(x):
            print("the port's checker looks for torch's capture points")
            return x


        def helper(x):
            print("not captured, prints are fine")
            return x.item()


        with torch.no_grad():
            helper(torch.ones(1))
    ''')
    assert jit_check_file(path, tmp_path) == []


def test_jit_purity_disable_comment(tmp_path):
    path = _write(tmp_path, "src/repro_torch/waived.py", '''
        import time
        import torch


        @torch.compile
        def kernel(x):
            t = time.time()  # lint: disable=jit-purity
            # lint: disable=jit-purity (read once, on purpose)
            n = x.item()
            return x + t + n
    ''')
    assert jit_check_file(path, tmp_path) == []


def test_jit_purity_skips_the_lint_package(tmp_path):
    root = tmp_path / "repo"
    _write(root, "src/repro_torch/lint/example.py", '''
        import torch

        @torch.compile
        def f(x):
            print(x)
    ''')
    from repro_torch.lint.jit_purity import check_jit_purity
    assert check_jit_purity(root) == []
    _write(root, "src/repro_torch/core/example.py",
           (root / "src/repro_torch/lint/example.py").read_text())
    assert len(check_jit_purity(root)) == 1


# ======================================================================
# the command line
# ======================================================================
def _cli_rows(capsys):
    out = capsys.readouterr().out
    return [line.split()[0::3] for line in out.splitlines()
            if line.startswith("  ")], out


def test_cli_exit_contract_and_rows_equal_reference(tmp_path, monkeypatch,
                                                    capsys):
    ref_root = ref_tests._layer_tree(tmp_path / "a")
    port_root = _port_layer_tree(tmp_path / "b")
    monkeypatch.setattr(ref_fp, "MANIFEST_PATH", tmp_path / "ref.json")
    monkeypatch.setattr(port_fp, "MANIFEST_PATH", tmp_path / "port.json")
    runs = {}
    for name, cli, root in (("ref", ref_cli, ref_root),
                            ("port", port_cli, port_root)):
        argv = ["--root", str(root), "--only", "version-integrity"]
        assert cli.main(argv + ["--update-manifest"]) == 0
        capsys.readouterr()
        clean = cli.main(argv + ["--check-manifest"])
        clean_rows, _ = _cli_rows(capsys)
        _edit(root, "src/" + ("repro" if name == "ref" else "repro_torch")
              + "/core/offload.py", ("max(levels)", "min(levels)"))
        drift = cli.main(argv + ["--check-manifest"])
        drift_rows, out = _cli_rows(capsys)
        runs[name] = (clean, clean_rows, drift, drift_rows)
        assert "FAILED" in out
    assert runs["port"] == runs["ref"]
    clean, clean_rows, drift, drift_rows = runs["port"]
    assert (clean, drift) == (0, 1)
    assert [r[-1] for r in clean_rows] == ["ok"] * 5
    assert [r[-1] for r in drift_rows] == [
        "ok", "DRIFT", "ok", "ok", "ok"]


def test_cli_baseline_flag_and_verbose(tmp_path, capsys):
    ref_root, port_root = _trees(tmp_path, "src/repro/dse/engine.py",
                                 _THREAD_CASES["racy_counter"])
    found = port_threads.check_threads(port_root)
    baseline = tmp_path / "baseline.json"
    port_core.save_baseline({found[0].key: "test-only counter"}, baseline)
    argv = ["--root", str(port_root), "--only", "thread-safety"]
    assert port_cli.main(argv) == 1
    capsys.readouterr()
    assert port_cli.main(argv + ["--baseline", str(baseline),
                                 "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "baseline: test-only counter" in out
    assert "repro_torch.lint: clean" in out


# ======================================================================
# the tree
# ======================================================================
def test_port_tree_is_lint_clean():
    """``python -m repro_torch.lint`` must exit 0 on the tree as
    committed."""
    report = port_core.run_checkers()
    rendered = "\n".join(f.render() for f in report.findings)
    assert report.ok, f"lint findings on the port's tree:\n{rendered}"
    assert report.suppressed == []


def test_port_manifest_matches_tree():
    committed = port_fp.load_manifest()
    assert committed, "manifest.json missing: run --update-manifest"
    assert committed == port_fp.compute_manifest(ROOT), \
        "fingerprint drift: bump the layer's constant and run " \
        "python -m repro_torch.lint --update-manifest"


_BLOCKED_LINT = r"""
import json, runpy, sys
for name in ("torch", "jax", "jaxlib", "repro", "numpy", "triton"):
    sys.modules[name] = None           # any import of them now fails
sys.argv = ["repro_torch.lint", "--check-manifest"]
try:
    runpy.run_module("repro_torch.lint", run_name="__main__", alter_sys=True)
    code = 0
except SystemExit as exc:
    code = exc.code
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("torch", "jax", "jaxlib", "repro",
                                        "numpy", "triton"))
print(json.dumps({"code": code, "loaded": loaded}))
"""


def test_lint_runs_with_torch_jax_numpy_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_LINT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert json.loads(lines[-1]) == {"code": 0, "loaded": []}
    rows = [line.split() for line in lines if line.startswith("  ")]
    assert [(r[0], r[-1]) for r in rows] == [
        (layer.name, "ok") for layer in port_fp.LAYERS]
    assert "repro_torch.lint: clean" in proc.stdout
