"""jit-purity checker: no Python side effects inside captured functions.

Twin of ``repro/lint/jit_purity.py`` over the port's tree, with torch's
capture points in place of ``jax.jit`` / ``lax.scan`` / ``pallas_call``.
A function handed to ``torch.compile``, ``torch.jit.script`` /
``torch.jit.trace`` or ``torch.cuda.make_graphed_callables``, or called
inside a ``with torch.cuda.graph(...)`` capture, runs its Python body
while the capture is made; what that body does on the host is baked into
the captured graph, replayed from a guard cache, or breaks the capture.
The classic bugs this catches:

* ``time.*`` / ``datetime.now`` / ``random.*`` / ``np.random.*`` — the
  value is frozen at capture time, every replay reuses it;
* ``os.environ`` / ``os.getenv`` — config reads that don't trigger a new
  capture when the env changes (read env *outside* and pass the result
  in);
* ``print`` / ``open`` — effects that happen once, not per call;
* ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``np.asarray(...)`` on captured tensors — host syncs that break a CUDA
  graph capture or a compiled graph;
* mutable default arguments — one object shared by every call, seen by
  the capture in the state it had then.

Detection is name-based and conservative: we only inspect functions we
can *see* flowing into a capture point (decorator, call or a
``torch.cuda.graph`` body), resolving through the transparent wrappers
``functools.partial``, ``torch.func.vmap`` and ``torch.vmap``.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.lint.core import (Finding, file_comments, is_disabled,
                                   parse_file, rel, register)

# call/decorator heads that mark their first argument (or the decorated
# function) as captured
_CAPTURE_WRAPPERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                     "torch.cuda.make_graphed_callables"}
# context managers whose body is captured
_GRAPH_HEADS = {"torch.cuda.graph"}
# transparent wrappers: unwrap to their first positional argument
_TRANSPARENT = {"functools.partial", "partial", "torch.func.vmap",
                "torch.vmap"} | _CAPTURE_WRAPPERS

_RANDOM_PREFIXES = ("random.", "np.random.", "numpy.random.", "onp.random.")
_TIME_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
               "time.process_time", "time.time_ns", "time.sleep"}
_HOST_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                    "numpy.array", "onp.asarray", "onp.array", "float",
                    "int"}  # float()/int() on captured values also sync
# tensor methods that copy to the host and wait for the device
_HOST_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_ENV_CALLS = {"os.getenv", "os.environ.get"}


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _first_pos_arg(call: ast.Call) -> Optional[ast.expr]:
    return call.args[0] if call.args else None


def _unwrap(expr: ast.expr) -> Optional[ast.expr]:
    """Chase ``torch.compile(torch.vmap(f, ...))`` down to f."""
    seen = 0
    while isinstance(expr, ast.Call) and seen < 8:
        head = dotted(expr.func)
        if head in _TRANSPARENT:
            nxt = _first_pos_arg(expr)
            if nxt is None:
                return None
            expr, seen = nxt, seen + 1
        else:
            return expr
    return expr


class _DefIndex(ast.NodeVisitor):
    """name -> [def nodes] over the whole file (scope-insensitive; good
    enough for lint — a shadowed name just gets both candidates checked)."""

    def __init__(self) -> None:
        self.defs: Dict[str, List[ast.AST]] = {}

    def visit_FunctionDef(self, node):
        self.defs.setdefault(node.name, []).append(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def _resolved(arg: ast.expr, head: str, index: Dict[str, List[ast.AST]]
              ) -> Iterable[Tuple[ast.AST, str]]:
    """The functions an argument of a capture point names: a lambda, a
    def by name, or each element of a tuple or list of them (as
    ``make_graphed_callables`` takes)."""
    if isinstance(arg, (ast.Tuple, ast.List)):
        for elt in arg.elts:
            yield from _resolved(elt, head, index)
        return
    resolved = _unwrap(arg)
    if isinstance(resolved, ast.Lambda):
        yield resolved, f"{head}(<lambda>)"
    elif isinstance(resolved, ast.Name):
        for d in index.get(resolved.id, ()):
            yield d, f"{head}({resolved.id})"


def _capture_targets(tree: ast.Module, index: Dict[str, List[ast.AST]]
                     ) -> Iterable[Tuple[ast.AST, str]]:
    """Yield (function node or captured ``with`` block, how it got
    captured) pairs."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                head = dotted(dec)
                if head is None and isinstance(dec, ast.Call):
                    head = dotted(dec.func)
                    # functools.partial(torch.compile, ...) as a decorator
                    if head in {"functools.partial", "partial"}:
                        inner = _first_pos_arg(dec)
                        head = dotted(inner) if inner is not None else None
                if head in _CAPTURE_WRAPPERS:
                    yield node, f"@{head}"
        elif isinstance(node, ast.Call):
            head = dotted(node.func)
            if head in _CAPTURE_WRAPPERS:
                arg = _first_pos_arg(node)
                if arg is not None:
                    yield from _resolved(arg, head, index)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            heads = {dotted(item.context_expr.func) for item in node.items
                     if isinstance(item.context_expr, ast.Call)}
            head = next((h for h in heads if h in _GRAPH_HEADS), None)
            if head is None:
                continue
            yield node, f"with {head}(...)"
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Name)):
                        for d in index.get(sub.func.id, ()):
                            yield d, f"with {head}(...): {sub.func.id}()"


def _impurities(fn: ast.AST) -> Iterable[Tuple[int, str]]:
    """(line, message) for each side effect in a captured body."""
    # one default object is shared by every call
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        args = fn.args
        for default in list(args.defaults) + [d for d in args.kw_defaults
                                              if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(default, ast.Call)
                    and dotted(default.func) in {"list", "dict", "set"}):
                yield (default.lineno,
                       "mutable default argument in a captured function "
                       "(one object shared by every call; the capture "
                       "sees its state at capture time)")
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Global):
                yield (node.lineno,
                       "`global` statement inside a captured function")
            elif isinstance(node, ast.Subscript):
                if dotted(node.value) == "os.environ":
                    yield (node.lineno,
                           "os.environ read inside a captured function "
                           "(frozen at capture time; read it outside and "
                           "pass the value in)")
            elif isinstance(node, ast.Call):
                head = dotted(node.func)
                if head is None:
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr in _HOST_SYNC_METHODS):
                        yield (node.lineno,
                               f".{node.func.attr}() host sync inside a "
                               f"captured function")
                    continue
                if head in _TIME_CALLS or head.startswith("datetime."):
                    yield (node.lineno,
                           f"{head}() inside a captured function is frozen "
                           f"at capture time")
                elif head.startswith(_RANDOM_PREFIXES):
                    yield (node.lineno,
                           f"{head}() inside a captured function is frozen "
                           f"at capture time (draw with torch on the "
                           f"device, or pass the value in)")
                elif head in _ENV_CALLS:
                    yield (node.lineno,
                           f"{head}() inside a captured function (frozen "
                           f"at capture time; read env outside and pass "
                           f"the value in)")
                elif head in {"print", "open"}:
                    yield (node.lineno,
                           f"{head}() inside a captured function runs at "
                           f"capture time only")
                elif head in _HOST_SYNC_CALLS and head not in {"float",
                                                               "int"}:
                    yield (node.lineno,
                           f"{head}() on a captured value is a host sync "
                           f"inside a captured function")
                elif head.rpartition(".")[2] in _HOST_SYNC_METHODS \
                        and "." in head:
                    yield (node.lineno,
                           f".{head.rpartition('.')[2]}() host sync inside "
                           f"a captured function")


def check_file(path: pathlib.Path, root: pathlib.Path) -> List[Finding]:
    tree = parse_file(path)
    indexer = _DefIndex()
    indexer.visit(tree)
    comments = file_comments(path)
    rpath = rel(path, root)
    seen: Set[Tuple[str, int, str]] = set()
    out: List[Finding] = []
    done_fns: Set[int] = set()
    for fn, how in _capture_targets(tree, indexer.defs):
        if id(fn) in done_fns:
            continue
        done_fns.add(id(fn))
        name = getattr(fn, "name", None) or (
            "<lambda>" if isinstance(fn, ast.Lambda) else "<capture>")
        for line, msg in _impurities(fn):
            key = (rpath, line, msg)
            if key in seen or is_disabled(comments, line, "jit-purity"):
                continue
            seen.add(key)
            out.append(Finding(
                checker="jit-purity", path=rpath, line=line,
                symbol=f"{name}:{msg.split(' ', 1)[0]}",
                message=f"{msg} [{name} captured via {how}]"))
    return out


@register("jit-purity")
def check_jit_purity(root: pathlib.Path) -> List[Finding]:
    findings: List[Finding] = []
    src = root / "src" / "repro_torch"
    for path in sorted(src.rglob("*.py")):
        if "lint" in path.relative_to(src).parts:
            continue
        findings.extend(check_file(path, root))
    return findings
