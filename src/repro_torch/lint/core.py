"""Framework plumbing for :mod:`repro_torch.lint` — findings, comments,
baseline.

Twin of ``repro/lint/core.py``, a stdlib copy.  Everything here is
deliberately stdlib-only (``ast`` + ``tokenize``): the lint runs before
any dependency is installed, and imports neither torch nor the JAX
package.

Three concepts:

* :class:`Finding` — one invariant violation, anchored by a *stable key*
  (checker + file + symbol) rather than a line number, so a committed
  suppression survives unrelated edits to the same file.
* **Annotations** — structured comments the checkers read through
  :func:`file_comments` (``tokenize``-based, so ``#`` inside string
  literals never confuses them): ``# lint: guarded-by(<lock>)`` declares
  a lock-protected attribute, ``# lint: numpy-twin(<target>)`` declares
  a kernel wrapper's plain PyTorch version, and
  ``# lint: disable=<checker>`` suppresses one line in place.
* **Baseline** — a committed JSON file of known findings, each with a
  mandatory one-line justification.  The runner exits non-zero only on
  findings *not* in the baseline, so adopting a new checker never blocks
  the tree while real cleanups land incrementally.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import pathlib
import re
import tokenize
from typing import Callable, Dict, List, Optional, Tuple

# src/repro_torch/lint/core.py -> parents[3] == the repository root
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

_DISABLE_RE = re.compile(r"lint:\s*disable=([\w,-]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``symbol`` anchors the baseline key: the function, attribute, or
    layer the finding is about.  Line numbers are for humans only —
    they never participate in suppression matching.
    """

    checker: str
    path: str                   # repo-relative, posix separators
    line: int
    message: str
    symbol: str = ""
    severity: str = "error"     # "error" fails the run; "warning" is advisory

    @property
    def key(self) -> str:
        return f"{self.checker}:{self.path}:{self.symbol or self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


# ----------------------------------------------------------------- files
def rel(path: pathlib.Path, root: pathlib.Path) -> str:
    return path.resolve().relative_to(root.resolve()).as_posix()


def parse_file(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def file_comments(path: pathlib.Path) -> Dict[int, str]:
    """``{lineno: comment text}`` for every ``#`` comment in the file.

    Tokenize-based: a ``#`` inside a string literal is not a comment."""
    out: Dict[int, str] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenError:
        pass
    return out


def annotation(comments: Dict[int, str], lines: range,
               name: str) -> Optional[str]:
    """The argument of the first ``lint: <name>(<arg>)`` annotation found
    on any line of ``lines`` (e.g. the span of a ``def`` statement)."""
    pat = re.compile(r"lint:\s*" + re.escape(name) + r"\(([^)]*)\)")
    for ln in lines:
        c = comments.get(ln)
        if c is None:
            continue
        m = pat.search(c)
        if m is not None:
            return m.group(1).strip()
    return None


def is_disabled(comments: Dict[int, str], line: int, checker: str) -> bool:
    """True when ``line`` (or the line above it) carries
    ``# lint: disable=<checker>``."""
    for ln in (line, line - 1):
        c = comments.get(ln)
        if c is None:
            continue
        m = _DISABLE_RE.search(c)
        if m and checker in {x.strip() for x in m.group(1).split(",")}:
            return True
    return False


# -------------------------------------------------------------- baseline
BASELINE_PATH = pathlib.Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Optional[pathlib.Path] = None) -> Dict[str, str]:
    """``{finding key: justification}`` from the committed baseline."""
    path = path or BASELINE_PATH
    if not path.exists():
        return {}
    doc = json.loads(path.read_text())
    out: Dict[str, str] = {}
    for entry in doc.get("suppressions", []):
        key, why = entry.get("key", ""), entry.get("justification", "")
        if not key or not why.strip():
            raise ValueError(
                f"baseline entry {entry!r} needs both a key and a "
                f"non-empty one-line justification")
        out[key] = why
    return out


def save_baseline(entries: Dict[str, str],
                  path: Optional[pathlib.Path] = None) -> None:
    path = path or BASELINE_PATH
    doc = {"format": 1,
           "suppressions": [{"key": k, "justification": v}
                            for k, v in sorted(entries.items())]}
    path.write_text(json.dumps(doc, indent=2) + "\n")


# -------------------------------------------------------------- registry
CHECKERS: Dict[str, Callable[[pathlib.Path], List[Finding]]] = {}


def register(name: str):
    """Register ``fn(repo_root) -> [Finding]`` under ``name``."""
    def deco(fn):
        CHECKERS[name] = fn
        return fn
    return deco


@dataclasses.dataclass
class LintReport:
    """Outcome of one lint run: new findings vs. baselined ones."""

    findings: List[Finding]                   # not in the baseline
    suppressed: List[Tuple[Finding, str]]     # (finding, justification)
    checkers: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)


def run_checkers(root: Optional[pathlib.Path] = None,
                 only: Optional[Tuple[str, ...]] = None,
                 baseline: Optional[Dict[str, str]] = None) -> LintReport:
    """Run the registered checkers and split results against the baseline."""
    # import for side effect: checker modules self-register
    from repro_torch.lint import (fingerprint, jit_purity, parity,  # noqa: F401
                                  threads)
    root = root or REPO_ROOT
    names = tuple(only) if only else tuple(sorted(CHECKERS))
    unknown = set(names) - set(CHECKERS)
    if unknown:
        raise ValueError(f"unknown checker(s) {sorted(unknown)}; "
                         f"known: {sorted(CHECKERS)}")
    if baseline is None:
        baseline = load_baseline()
    new: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    for name in names:
        for f in CHECKERS[name](root):
            if f.key in baseline:
                suppressed.append((f, baseline[f.key]))
            else:
                new.append(f)
    new.sort(key=lambda f: (f.path, f.line, f.checker))
    return LintReport(findings=new, suppressed=suppressed, checkers=names)
