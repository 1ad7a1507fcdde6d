"""version-integrity checker: AST fingerprints behind the version constants.

Twin of ``repro/lint/fingerprint.py`` over the port's tree.  The port's
stores trust five hand-bumped constants to invalidate cached artifacts
(``TRACE_VM_VERSION``, ``ANALYSIS_VERSION``, ``TPU_ANALYSIS_VERSION``,
``SAMPLING_VERSION``, ``STORE_FORMAT``).  Nothing at runtime can tell
that the code producing an artifact changed while its version constant
did not — the cache key still matches and a stale artifact is served
silently.  This checker closes that hole statically:

* each versioned layer maps to a set of modules (or, for layers that
  share a file with unrelated code, a set of top-level symbols);
* the layer's source is normalized — docstrings dropped, local names
  canonicalized by first appearance, the version constant itself
  excluded — and hashed;
* a committed manifest (``manifest.json``) records the
  ``(version, fingerprint)`` pair per layer;
* a mismatch is an error telling you which constant to bump and to run
  ``python -m repro_torch.lint --update-manifest``.

Normalization is deliberately *behavior-shaped*, not byte-shaped:
renaming a local variable, editing a comment, or rewording a docstring
does not change the fingerprint; changing control flow, arithmetic, an
attribute name, or a public signature does.  The checker cannot prove a
change is semantic — it forces a human decision where today there is
silence.

The hash is over :func:`dump`, not ``ast.dump``: ``ast.dump``'s text
changes between interpreter versions (3.12 prints the ``type_params``
field it added to every def and class), so the same source would
fingerprint differently under 3.11 and 3.12.  :func:`dump` leaves out
every field that is ``None`` or an empty list.
"""
from __future__ import annotations

import ast
import copy
import hashlib
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.lint.core import Finding, parse_file, register

MANIFEST_PATH = pathlib.Path(__file__).resolve().parent / "manifest.json"


class LayerSpec:
    """One versioned artifact layer: modules + the constant that gates it."""

    def __init__(self, name: str, version_const: str, version_module: str,
                 modules: Sequence[str],
                 symbols: Optional[Dict[str, Sequence[str]]] = None):
        self.name = name
        self.version_const = version_const
        self.version_module = version_module   # module holding the constant
        self.modules = tuple(modules)          # repo-relative paths
        # optional per-module symbol filter: only these top-level defs /
        # ClassName.method paths participate in the fingerprint (for
        # modules where the layer shares a file with unrelated code)
        self.symbols = {k: tuple(v) for k, v in (symbols or {}).items()}


LAYERS: Tuple[LayerSpec, ...] = (
    LayerSpec(
        name="trace-vm",
        version_const="TRACE_VM_VERSION",
        version_module="src/repro_torch/core/trace.py",
        # every workload's instructions also come from the lowering
        # helpers, and the store keys a trace only on its own module
        # (store.workload_fingerprint), so they belong to the VM's layer
        modules=("src/repro_torch/core/trace.py",
                 "src/repro_torch/core/columnar.py",
                 "src/repro_torch/core/isa.py",
                 "src/repro_torch/workloads/lowering.py"),
    ),
    LayerSpec(
        name="analysis",
        version_const="ANALYSIS_VERSION",
        version_module="src/repro_torch/core/offload.py",
        # the constant's own docstring declares it covers idg + offload +
        # reshape, so reshape.py is in the fingerprint too
        modules=("src/repro_torch/core/offload.py",
                 "src/repro_torch/core/idg.py",
                 "src/repro_torch/core/reshape.py"),
    ),
    LayerSpec(
        name="tpu-analysis",
        version_const="TPU_ANALYSIS_VERSION",
        version_module="src/repro_torch/dse/backends.py",
        modules=("src/repro_torch/dse/backends.py",),
        # backends.py also holds CimBackend, which is covered by the
        # trace-vm/analysis layers it delegates to — only the TPU path
        # feeds TPU_ANALYSIS_VERSION-keyed artifacts
        symbols={"src/repro_torch/dse/backends.py": (
            "TpuCandidate", "TpuWorkloadAnalysis", "TpuSelection",
            "TpuBackend", "arch_fingerprint")},
    ),
    LayerSpec(
        name="sampling",
        version_const="SAMPLING_VERSION",
        version_module="src/repro_torch/core/sampling/spec.py",
        # everything that shapes a persisted sampled artifact or the
        # estimate computed from it: the spec/key schema, the skim and
        # windowed machines, plan construction, the sampled pipeline, and
        # the estimator
        modules=("src/repro_torch/core/sampling/spec.py",
                 "src/repro_torch/core/sampling/machines.py",
                 "src/repro_torch/core/sampling/cluster.py",
                 "src/repro_torch/core/sampling/pipeline.py",
                 "src/repro_torch/core/sampling/estimate.py"),
    ),
    LayerSpec(
        name="store-format",
        version_const="STORE_FORMAT",
        version_module="src/repro_torch/dse/store.py",
        modules=("src/repro_torch/dse/store.py",),
        # only the on-disk envelope + key derivation; stats/usage paths
        # can change freely without invalidating stored artifacts
        symbols={"src/repro_torch/dse/store.py": (
            "NPZ_FORMAT", "workload_fingerprint", "_cache_geometry",
            "_offload_spec",
            "AnalysisStore._key", "AnalysisStore._path",
            "AnalysisStore.layer1_key", "AnalysisStore.layer2_key",
            "AnalysisStore._read", "AnalysisStore._write",
            "AnalysisStore._flow_path",
            "AnalysisStore._write_npz", "AnalysisStore._read_npz")},
    ),
)


# ---------------------------------------------------------- normalization
class _Normalizer(ast.NodeTransformer):
    """Canonicalize an AST so only behavior-shaped edits change the dump.

    * docstrings (first Constant-str statement of module/class/def) drop;
    * every local name (``Name.id``, ``arg.arg``, except-handler and
      global/nonlocal names) is renamed to ``_nN`` by first appearance —
      so renames don't bump versions but data-flow changes do;
    * def/class names, attribute names, and keyword argument names are
      KEPT: they are API surface and cache-key material.
    """

    def __init__(self) -> None:
        self._names: Dict[str, str] = {}

    def _canon(self, name: str) -> str:
        if name not in self._names:
            self._names[name] = f"_n{len(self._names)}"
        return self._names[name]

    def _strip_docstring(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        self.generic_visit(node)
        return self._strip_docstring(node)

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        return self._strip_docstring(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.generic_visit(node)
        return self._strip_docstring(node)

    def visit_Name(self, node):
        node.id = self._canon(node.id)
        return node

    def visit_arg(self, node):
        self.generic_visit(node)
        node.arg = self._canon(node.arg)
        return node

    def visit_ExceptHandler(self, node):
        self.generic_visit(node)
        if node.name:
            node.name = self._canon(node.name)
        return node

    def visit_Global(self, node):
        node.names = [self._canon(n) for n in node.names]
        return node

    visit_Nonlocal = visit_Global


def _select_symbols(tree: ast.Module, wanted: Sequence[str]) -> ast.Module:
    """Reduce a module to the listed top-level symbols.

    ``"name"`` keeps a top-level def/class/assign target; ``"Cls.meth"``
    keeps just that method (wrapped in a stub class so nesting survives).
    """
    flat = {w for w in wanted if "." not in w}
    methods: Dict[str, set] = {}
    for w in wanted:
        if "." in w:
            cls, meth = w.split(".", 1)
            methods.setdefault(cls, set()).add(meth)
    body: List[ast.stmt] = []
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if stmt.name in flat:
                body.append(stmt)
        elif isinstance(stmt, ast.ClassDef):
            if stmt.name in flat:
                body.append(stmt)
            elif stmt.name in methods:
                keep = [s for s in stmt.body
                        if isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and s.name in methods[stmt.name]]
                stub = ast.ClassDef(name=stmt.name, bases=[], keywords=[],
                                    body=keep or [ast.Pass()],
                                    decorator_list=[])
                body.append(stub)
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            names = {t.id for t in targets if isinstance(t, ast.Name)}
            if names & flat:
                body.append(stmt)
    out = ast.Module(body=body, type_ignores=[])
    return out


def _drop_assign(tree: ast.Module, name: str) -> ast.Module:
    """Remove the version constant's own assignment: bumping it must not
    move the code fingerprint."""
    tree.body = [
        s for s in tree.body
        if not (isinstance(s, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in s.targets))
        and not (isinstance(s, ast.AnnAssign)
                 and isinstance(s.target, ast.Name)
                 and s.target.id == name)]
    return tree


def normalize(tree: ast.Module, version_const: str,
              symbols: Optional[Sequence[str]] = None) -> ast.Module:
    """The tree a layer's module contributes: its ``symbols`` only (all of
    it without a filter), the version constant's assignment dropped,
    then :class:`_Normalizer` on a copy."""
    if symbols:
        tree = _select_symbols(tree, symbols)
    tree = _drop_assign(tree, version_const)
    return _Normalizer().visit(copy.deepcopy(tree))


def dump(node) -> str:
    """A text of ``node`` that one source gives under every interpreter:
    ``Type(field=value, ...)`` over ``node._fields``, without the fields
    that are ``None`` or an empty list (fields an interpreter added, such
    as 3.12's ``type_params``, are one of these where unused) and without
    positions."""
    if isinstance(node, ast.AST):
        fields = []
        for name in node._fields:
            value = getattr(node, name, None)
            if value is None or (isinstance(value, list) and not value):
                continue
            fields.append(f"{name}={dump(value)}")
        return f"{type(node).__name__}({', '.join(fields)})"
    if isinstance(node, list):
        return "[" + ", ".join(dump(x) for x in node) + "]"
    return repr(node)


def layer_fingerprint(layer: LayerSpec, root: pathlib.Path) -> str:
    """sha256 over the normalized dumps of the layer's modules."""
    h = hashlib.sha256()
    for mod in layer.modules:
        tree = normalize(parse_file(root / mod), layer.version_const,
                         layer.symbols.get(mod))
        h.update(mod.encode())
        h.update(dump(tree).encode())
    return h.hexdigest()


def read_version(layer: LayerSpec, root: pathlib.Path) -> Optional[int]:
    """The current value of the layer's version constant, statically."""
    tree = parse_file(root / layer.version_module)
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if (isinstance(t, ast.Name) and t.id == layer.version_const
                        and isinstance(stmt.value, ast.Constant)):
                    return stmt.value.value
    return None


# --------------------------------------------------------------- manifest
def compute_manifest(root: pathlib.Path) -> Dict[str, Dict[str, object]]:
    out: Dict[str, Dict[str, object]] = {}
    for layer in LAYERS:
        out[layer.name] = {
            "version_const": layer.version_const,
            "version": read_version(layer, root),
            "modules": list(layer.modules),
            "fingerprint": layer_fingerprint(layer, root),
        }
    return out


def load_manifest(path: Optional[pathlib.Path] = None) -> Dict[str, Dict]:
    path = path or MANIFEST_PATH
    if not path.exists():
        return {}
    return json.loads(path.read_text()).get("layers", {})


def save_manifest(root: pathlib.Path,
                  path: Optional[pathlib.Path] = None) -> Dict[str, Dict]:
    path = path or MANIFEST_PATH
    layers = compute_manifest(root)
    path.write_text(json.dumps({"format": 1, "layers": layers}, indent=2)
                    + "\n")
    return layers


@register("version-integrity")
def check_versions(root: pathlib.Path,
                   manifest_path: Optional[pathlib.Path] = None
                   ) -> List[Finding]:
    manifest = load_manifest(manifest_path)
    findings: List[Finding] = []
    if not manifest:
        return [Finding(
            checker="version-integrity",
            path="src/repro_torch/lint/manifest.json",
            line=1, symbol="<manifest>",
            message="no committed manifest; run "
                    "`python -m repro_torch.lint --update-manifest`")]
    for layer in LAYERS:
        rec = manifest.get(layer.name)
        const_at = f"{layer.version_module}"
        if rec is None:
            findings.append(Finding(
                checker="version-integrity", path=const_at, line=1,
                symbol=layer.name,
                message=f"layer '{layer.name}' missing from manifest; run "
                        f"`python -m repro_torch.lint --update-manifest`"))
            continue
        cur_fp = layer_fingerprint(layer, root)
        cur_ver = read_version(layer, root)
        if cur_ver is None:
            findings.append(Finding(
                checker="version-integrity", path=const_at, line=1,
                symbol=layer.name,
                message=f"cannot find constant {layer.version_const} "
                        f"in {layer.version_module}"))
            continue
        if cur_fp == rec.get("fingerprint") and cur_ver == rec.get("version"):
            continue
        if cur_fp != rec.get("fingerprint") and cur_ver == rec.get("version"):
            findings.append(Finding(
                checker="version-integrity", path=const_at, line=1,
                symbol=layer.name,
                message=(
                    f"code behind {layer.version_const} changed but the "
                    f"constant is still {cur_ver} — cached artifacts would "
                    f"go stale silently. Bump {layer.version_const} in "
                    f"{layer.version_module} and run `python -m "
                    f"repro_torch.lint --update-manifest` (or run "
                    f"--update-manifest alone for a provably non-semantic "
                    f"refactor)")))
        else:
            findings.append(Finding(
                checker="version-integrity", path=const_at, line=1,
                symbol=layer.name,
                message=(
                    f"{layer.version_const} is {cur_ver} but the manifest "
                    f"records {rec.get('version')}; run `python -m "
                    f"repro_torch.lint --update-manifest` to re-record the "
                    f"layer")))
    return findings
