"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` (or any other ``.cu`` file given to
:func:`build` / :func:`load`) becomes one shared library with a plain C
interface, loaded with ``ctypes``; it includes no PyTorch header, so a
build takes seconds.  Libraries land in ``build/repro_torch_kernels/`` at
the root of the checkout (git-ignored), named by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
All missing libraries are compiled in parallel, one ``nvcc`` per source.

Nothing here runs at import: ``nvcc`` is needed only when a kernel is
first launched, or when :func:`build` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[4] / "build"
             / "repro_torch_kernels")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[pathlib.Path, ctypes.CDLL] = {}
#: compiler output per source of the last build (register/smem report)
build_logs: Dict[str, str] = {}


def sources() -> Dict[str, pathlib.Path]:
    """Kernel name -> source file, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(srcs: Optional[Iterable[pathlib.Path]] = None) -> Dict[str, float]:
    """Compile the given ``.cu`` files (default: every kernel source) that
    are not built yet, all at once; returns seconds per compiled source,
    keyed by its stem.  Raises with the compiler's output if any build
    fails."""
    srcs = list(sources().values() if srcs is None else srcs)
    todo = [src for src in srcs if not _target(src).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for src in todo:
        tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (tmp, subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[src.stem] = time.perf_counter() - start
        build_logs[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"--- {src.name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, _target(src))      # atomic across processes
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def load(src: pathlib.Path) -> ctypes.CDLL:
    """The loaded library of the ``.cu`` file ``src``, built on first use."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            build([src])
            lib = _libs[src] = ctypes.CDLL(str(_target(src)))
        return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of the kernel source ``csrc/<name>.cu``."""
    return load(CSRC / f"{name}.cu")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        fn = lib.error_string
        fn.argtypes, fn.restype = (ctypes.c_int,), ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({fn(rc).decode(errors='replace')})")
