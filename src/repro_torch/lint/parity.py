"""accel-parity checker: every kernel wrapper keeps its plain version.

Twin of ``repro/lint/parity.py`` over the port's tree.  The port's
contract is that each wrapper of ``core/accel/`` launches its CUDA kernel
on a CUDA tensor and runs its plain PyTorch version on a CPU tensor, with
the same answer.  That contract has three mechanical parts this checker
enforces for every *public* top-level function in ``core/accel/``
(except underscore modules: ``__init__.py``, which holds the launch
counters, and ``_build.py``, which builds kernels and wraps none):

1. a ``# lint: numpy-twin(<target>[, batched])`` annotation on the def
   naming the plain version — ``repro_torch.core.offload:_place`` style
   for in-repo twins, a plain dotted path
   (``torch.Tensor.index_add_``) for external ones;
2. for in-repo twins: the target exists and the signatures match
   (parameter names, in order, ``self`` excluded).  The ``batched``
   flag opts out of the signature comparison for wrappers that
   intentionally take a batch axis or an output buffer their plain
   version lacks;
3. a differential test in one of ``TEST_FILE`` referencing the wrapper
   by name.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import List, Optional, Tuple

from repro_torch.lint.core import (Finding, annotation, file_comments,
                                   is_disabled, parse_file, rel, register)

ACCEL_DIR = "src/repro_torch/core/accel"
TEST_FILE = ("tests/test_torch_kernels.py", "tests/test_torch_place.py")


def _params(fn: ast.FunctionDef, drop_self: bool) -> List[str]:
    a = fn.args
    names = ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args])
    if drop_self and names and names[0] in {"self", "cls"}:
        names = names[1:]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    names += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return names


def _resolve_twin(target: str, root: pathlib.Path
                  ) -> Tuple[Optional[ast.FunctionDef], bool, str]:
    """(def node, is_method, problem) for an in-repo ``mod:qualname``."""
    mod, _, qual = target.partition(":")
    path = root / "src" / pathlib.Path(*mod.split("."))
    path = path.with_suffix(".py")
    if not path.exists():
        return None, False, f"twin module {mod} not found at {path.name}"
    tree = parse_file(path)
    parts = qual.split(".")
    body = tree.body
    is_method = False
    node: Optional[ast.AST] = None
    for i, part in enumerate(parts):
        node = next((s for s in body
                     if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                       ast.ClassDef))
                     and s.name == part), None)
        if node is None:
            return None, False, f"twin symbol {qual} not found in {mod}"
        if isinstance(node, ast.ClassDef):
            body = node.body
            is_method = i + 1 < len(parts)
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None, False, f"twin {target} is not a function"
    return node, is_method, ""


@register("accel-parity")
def check_parity(root: pathlib.Path) -> List[Finding]:
    findings: List[Finding] = []
    accel = root / ACCEL_DIR
    test_src = "\n".join((root / t).read_text() for t in TEST_FILE
                         if (root / t).exists())
    for path in sorted(accel.glob("*.py")):
        if path.name.startswith("_"):
            continue
        tree = parse_file(path)
        comments = file_comments(path)
        rpath = rel(path, root)
        for node in tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            if node.name.startswith("_"):
                continue
            if is_disabled(comments, node.lineno, "accel-parity"):
                continue
            # annotation may sit on the line above the def, on the def
            # line, or on any signature line before the body starts
            span = range(node.lineno - 1, node.body[0].lineno)
            ann = annotation(comments, span, "numpy-twin")
            if ann is None:
                findings.append(Finding(
                    checker="accel-parity", path=rpath, line=node.lineno,
                    symbol=node.name,
                    message=(f"public accel function {node.name} has no "
                             f"`# lint: numpy-twin(<target>)` annotation "
                             f"naming its plain version")))
                continue
            parts = [p.strip() for p in ann.split(",")]
            target, batched = parts[0], "batched" in parts[1:]
            if target.startswith("repro_torch."):
                twin, is_method, problem = _resolve_twin(target, root)
                if twin is None:
                    findings.append(Finding(
                        checker="accel-parity", path=rpath,
                        line=node.lineno, symbol=node.name,
                        message=f"{node.name}: {problem}"))
                elif not batched:
                    ours = _params(node, drop_self=False)
                    theirs = _params(twin, drop_self=is_method)
                    if ours != theirs:
                        findings.append(Finding(
                            checker="accel-parity", path=rpath,
                            line=node.lineno, symbol=node.name,
                            message=(f"{node.name}{tuple(ours)} does not "
                                     f"match numpy twin {target}"
                                     f"{tuple(theirs)} (add `, batched` to "
                                     f"the annotation if the shape "
                                     f"difference is intentional)")))
            # external twins (torch.*) are taken on trust — the
            # differential test below is what actually verifies them
            if not re.search(rf"\b{re.escape(node.name)}\b", test_src):
                findings.append(Finding(
                    checker="accel-parity", path=rpath, line=node.lineno,
                    symbol=f"{node.name}:test",
                    message=(f"{node.name} has no differential test "
                             f"referencing it in "
                             f"{' or '.join(TEST_FILE)}")))
    return findings
