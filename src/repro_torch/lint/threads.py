"""thread-safety checker: guarded writes and lock ordering in the daemon.

Twin of ``repro/lint/threads.py`` over the port's tree.  The DSE daemon
shares engine/store/metrics state across handler threads.  The locking discipline is conventional — every shared
attribute has one designated lock — but nothing enforced it until now.

Declaration is explicit, on the owning assignment (usually in
``__init__``)::

    self._memo = {}          # lint: guarded-by(_memo_lock)

With that in place the checker flags, per class:

* any write to a guarded attribute — rebinding, ``+=``, subscript
  stores, ``del``, or a mutating method call (``append``, ``update``,
  ``pop``, ...) — outside a ``with self.<lock>:`` block;
* ``setattr(self, ...)`` outside every declared lock (dynamic writes
  can hit any guarded attribute);
* inconsistent lock-acquisition order: if one code path takes lock A
  then B and another takes B then A, both sites are reported (the
  classic ABBA deadlock).

``__init__`` is exempt (no concurrent access before construction
returns).  Writes inside *nested* functions are checked with an empty
held-lock set: a closure handed to an executor runs after the ``with``
block exited, so the enclosing lock proves nothing.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.lint.core import (Finding, file_comments, is_disabled,
                                   parse_file, rel, register)

THREADED = ("src/repro_torch/dse/service", "src/repro_torch/dse/engine.py",
            "src/repro_torch/dse/store.py",
            "src/repro_torch/ckpt/checkpoint.py", "src/repro_torch/obs")

_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "setdefault", "add", "discard",
             "appendleft", "popleft"}

_GUARD_RE = re.compile(r"lint:\s*guarded-by\((\w+)\)")


def _self_attr(node: ast.AST) -> Optional[str]:
    """``X`` when node is ``self.X``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _written_attrs(target: ast.AST) -> List[Tuple[str, int]]:
    """Guardable (attr, line) pairs written by an assignment target."""
    out: List[Tuple[str, int]] = []
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            out.extend(_written_attrs(elt))
        return out
    if isinstance(target, ast.Starred):
        return _written_attrs(target.value)
    attr = _self_attr(target)
    if attr is not None:
        out.append((attr, target.lineno))
    elif isinstance(target, ast.Subscript):
        attr = _self_attr(target.value)
        if attr is not None:
            out.append((attr, target.lineno))
    return out


def _collect_guards(cls: ast.ClassDef,
                    comments: Dict[int, str]) -> Dict[str, str]:
    """attr -> lock from ``# lint: guarded-by(<lock>)`` on assignments."""
    guards: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        lock = None
        for ln in range(node.lineno, end + 1):
            c = comments.get(ln)
            if c:
                m = _GUARD_RE.search(c)
                if m:
                    lock = m.group(1)
                    break
        if lock is None:
            continue
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                guards[attr] = lock
    return guards


class _ClassChecker:
    def __init__(self, cls: ast.ClassDef, guards: Dict[str, str],
                 comments: Dict[int, str], rpath: str):
        self.cls = cls
        self.guards = guards
        self.comments = comments
        self.rpath = rpath
        self.findings: List[Finding] = []
        # lock-order edges: (held, acquired) -> first line observed
        self.edges: Dict[Tuple[str, str], int] = {}

    def run(self) -> None:
        for node in self.cls.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name == "__init__":
                continue
            self._visit_block(node.body, held=frozenset(), method=node.name)

    # ------------------------------------------------------------ core
    def _flag(self, attr: str, line: int, method: str, kind: str) -> None:
        if is_disabled(self.comments, line, "thread-safety"):
            return
        lock = self.guards[attr]
        self.findings.append(Finding(
            checker="thread-safety", path=self.rpath, line=line,
            symbol=f"{self.cls.name}.{method}:{attr}",
            message=(f"{kind} of {self.cls.name}.{attr} (guarded-by "
                     f"{lock}) outside `with self.{lock}:` in "
                     f"{method}()")))

    def _with_locks(self, stmt: ast.With) -> Set[str]:
        locks: Set[str] = set()
        for item in stmt.items:
            attr = _self_attr(item.context_expr)
            if attr is not None:
                locks.add(attr)
        return locks

    def _visit_block(self, stmts: Sequence[ast.stmt],
                     held: frozenset, method: str) -> None:
        for stmt in stmts:
            self._visit_stmt(stmt, held, method)

    def _visit_stmt(self, stmt: ast.stmt, held: frozenset,
                    method: str) -> None:
        if isinstance(stmt, ast.With):
            acquired = self._with_locks(stmt)
            for a in held:
                for b in acquired:
                    if a != b:
                        self.edges.setdefault((a, b), stmt.lineno)
            self._check_exprs(stmt, held, method, skip_body=True)
            self._visit_block(stmt.body, held | acquired, method)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a closure may run after the lock was released (executor
            # submit, callback): check its body with nothing held
            self._visit_block(stmt.body, frozenset(), method=stmt.name)
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                for attr, line in _written_attrs(t):
                    if attr in self.guards and self.guards[attr] not in held:
                        kind = ("augmented write"
                                if isinstance(stmt, ast.AugAssign)
                                else "write")
                        self._flag(attr, line, method, kind)
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                for attr, line in _written_attrs(t):
                    if attr in self.guards and self.guards[attr] not in held:
                        self._flag(attr, line, method, "delete")
        self._check_exprs(stmt, held, method)
        if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While,
                             ast.Try)):
            for field in ("body", "orelse", "finalbody"):
                inner = getattr(stmt, field, None)
                if isinstance(inner, list):
                    self._visit_block(inner, held, method)
            for handler in getattr(stmt, "handlers", []):
                self._visit_block(handler.body, held, method)

    def _check_exprs(self, stmt: ast.stmt, held: frozenset, method: str,
                     skip_body: bool = False) -> None:
        """Mutating calls on guarded attrs anywhere in the statement's
        own expressions (not its nested statement body)."""
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
                attr = _self_attr(fn.value)
                if (attr is not None and attr in self.guards
                        and self.guards[attr] not in held
                        and self._owns(stmt, node, skip_body)):
                    self._flag(attr, node.lineno, method,
                               f".{fn.attr}() mutation")
            elif (isinstance(fn, ast.Name) and fn.id == "setattr"
                  and node.args
                  and isinstance(node.args[0], ast.Name)
                  and node.args[0].id == "self" and self.guards
                  and not (held & set(self.guards.values()))
                  and self._owns(stmt, node, skip_body)):
                if not is_disabled(self.comments, node.lineno,
                                   "thread-safety"):
                    self.findings.append(Finding(
                        checker="thread-safety", path=self.rpath,
                        line=node.lineno,
                        symbol=f"{self.cls.name}.{method}:setattr",
                        message=(f"setattr(self, ...) in {method}() "
                                 f"outside every declared lock of "
                                 f"{self.cls.name} (a dynamic write can "
                                 f"hit any guarded attribute)")))

    def _owns(self, stmt: ast.stmt, node: ast.AST, skip_body: bool) -> bool:
        """True when ``node`` belongs to this statement's own expressions
        — i.e. not inside a nested statement list we visit separately."""
        if not skip_body and not isinstance(stmt, (ast.If, ast.For,
                                                   ast.AsyncFor, ast.While,
                                                   ast.Try, ast.With)):
            return True
        nested: List[ast.stmt] = []
        for field in ("body", "orelse", "finalbody"):
            v = getattr(stmt, field, None)
            if isinstance(v, list):
                nested.extend(v)
        for h in getattr(stmt, "handlers", []):
            nested.extend(h.body)
        for sub in nested:
            for n in ast.walk(sub):
                if n is node:
                    return False
        return True


def _order_findings(all_edges: Dict[str, Dict[Tuple[str, str], int]],
                    rpaths: Dict[str, str]) -> List[Finding]:
    out: List[Finding] = []
    for cls_name, edges in all_edges.items():
        for (a, b), line in sorted(edges.items()):
            if (b, a) in edges and a < b:
                other = edges[(b, a)]
                out.append(Finding(
                    checker="thread-safety", path=rpaths[cls_name],
                    line=line, symbol=f"{cls_name}:lock-order:{a}/{b}",
                    message=(f"inconsistent lock order in {cls_name}: "
                             f"{a} -> {b} at line {line} but "
                             f"{b} -> {a} at line {other} (ABBA "
                             f"deadlock)")))
    return out


def _threaded_files(root: pathlib.Path) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for entry in THREADED:
        p = root / entry
        if p.is_dir():
            out.extend(sorted(p.glob("*.py")))
        elif p.exists():
            out.append(p)
    return out


@register("thread-safety")
def check_threads(root: pathlib.Path) -> List[Finding]:
    findings: List[Finding] = []
    all_edges: Dict[str, Dict[Tuple[str, str], int]] = {}
    rpaths: Dict[str, str] = {}
    for path in _threaded_files(root):
        tree = parse_file(path)
        comments = file_comments(path)
        rpath = rel(path, root)
        for node in tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            guards = _collect_guards(node, comments)
            if not guards:
                continue
            checker = _ClassChecker(node, guards, comments, rpath)
            checker.run()
            findings.extend(checker.findings)
            all_edges[node.name] = checker.edges
            rpaths[node.name] = rpath
    findings.extend(_order_findings(all_edges, rpaths))
    return findings
