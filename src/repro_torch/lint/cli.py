"""Command line for ``python -m repro_torch.lint``.

Twin of ``repro/lint/cli.py`` over the port's tree, with the same flags.

Exit status is the contract: 0 when the tree is clean (no findings
outside the committed baseline), 1 otherwise.  Modes:

* default / ``--check-manifest`` — run every checker; the explicit flag
  additionally prints the per-layer version/fingerprint table so a log
  shows *which* layer drifted;
* ``--update-manifest`` — re-record all layer fingerprints after an
  intentional version bump (the documented one-liner);
* ``--only <checker>`` — run a subset (repeatable);
* ``--verbose`` — also list baselined findings with their
  justifications.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time
from typing import Optional, Sequence

from repro_torch.lint import fingerprint
from repro_torch.lint.core import REPO_ROOT, load_baseline, run_checkers


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="repo invariant checker (version-integrity, "
                    "jit-purity, accel-parity, thread-safety)")
    ap.add_argument("--root", type=pathlib.Path, default=REPO_ROOT,
                    help="repository root (default: auto-detected)")
    ap.add_argument("--only", action="append", metavar="CHECKER",
                    help="run only this checker (repeatable)")
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="alternate baseline file (default: committed "
                         "src/repro_torch/lint/baseline.json)")
    ap.add_argument("--check-manifest", action="store_true",
                    help="run all checkers and print the per-layer "
                         "version/fingerprint table")
    ap.add_argument("--update-manifest", action="store_true",
                    help="re-record layer fingerprints in manifest.json "
                         "(run after an intentional version bump)")
    ap.add_argument("--verbose", action="store_true",
                    help="also list baselined findings")
    args = ap.parse_args(argv)

    if args.update_manifest:
        layers = fingerprint.save_manifest(args.root)
        for name, rec in layers.items():
            print(f"recorded {name}: {rec['version_const']}="
                  f"{rec['version']} fp={rec['fingerprint'][:12]}")
        print(f"wrote {fingerprint.MANIFEST_PATH}")
        return 0

    t0 = time.perf_counter()
    baseline = load_baseline(args.baseline)
    report = run_checkers(root=args.root,
                          only=tuple(args.only) if args.only else None,
                          baseline=baseline)
    dt = time.perf_counter() - t0

    if args.check_manifest:
        manifest = fingerprint.load_manifest()
        for layer in fingerprint.LAYERS:
            rec = manifest.get(layer.name, {})
            cur = fingerprint.layer_fingerprint(layer, args.root)
            ok = (cur == rec.get("fingerprint")
                  and fingerprint.read_version(layer, args.root)
                  == rec.get("version"))
            print(f"  {layer.name:<14} {layer.version_const}="
                  f"{rec.get('version')} fp={cur[:12]} "
                  f"{'ok' if ok else 'DRIFT'}")

    if args.verbose and report.suppressed:
        print(f"{len(report.suppressed)} baselined finding(s):")
        for f, why in report.suppressed:
            print(f"  {f.render()}")
            print(f"    baseline: {why}")

    for f in report.findings:
        print(f.render(), file=sys.stderr)

    n_err = sum(1 for f in report.findings if f.severity == "error")
    n_warn = len(report.findings) - n_err
    status = "clean" if report.ok else "FAILED"
    print(f"repro_torch.lint: {status} — {len(report.checkers)} checkers, "
          f"{n_err} error(s), {n_warn} warning(s), "
          f"{len(report.suppressed)} baselined, {dt:.2f}s")
    if not report.ok:
        print("fix the findings above, or baseline a false positive in "
              "src/repro_torch/lint/baseline.json with a justification",
              file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
