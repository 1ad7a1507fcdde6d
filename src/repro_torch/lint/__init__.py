"""Static invariant checks for the port (``src/repro_torch/``).

Twin of :mod:`repro.lint`.  ``python -m repro_torch.lint`` runs four
ast-based checkers over the port's tree:

* **version-integrity** — normalized AST fingerprints of the code
  behind each cache version constant, against a committed manifest;
* **jit-purity** — no Python side effects inside bodies that
  ``torch.compile``, ``torch.jit`` or a CUDA graph captures;
* **accel-parity** — every public ``core/accel`` wrapper declares its
  plain PyTorch version with a matching signature and a differential
  test;
* **thread-safety** — ``# lint: guarded-by(<lock>)`` attributes are
  only written under their lock, and locks nest in one global order.

Stdlib-only by design: it runs before any dependency is installed, and
imports neither torch nor JAX nor the ``repro`` package.
"""
from repro_torch.lint.core import (  # noqa: F401
    CHECKERS,
    Finding,
    LintReport,
    REPO_ROOT,
    load_baseline,
    run_checkers,
)
