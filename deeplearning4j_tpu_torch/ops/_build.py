"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
with :mod:`ctypes`. The build happens at first use, never at import, into
``build/`` at the repository root (git-ignored), under a name keyed by
:func:`source_digest` (the source and every shared ``csrc/*.cuh`` header),
so an edited source or header rebuilds and an unchanged one loads the
library already there. ``nvcc -Xptxas -v`` reports each kernel's registers,
shared memory and spills; :func:`load` keeps that report in
:data:`BUILD_LOG` and echoes it to stderr.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["BUILD_LOG", "build", "load", "nvcc_path", "source_digest"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "deeplearning4j_tpu_torch are built from source on the GPU host")


def source_digest(name: str, source_dir: Optional[Path] = None) -> str:
    """Hash of what a build of ``<name>.cu`` reads from ``source_dir``
    (default ``csrc/``): the source and every ``*.cuh`` header there, sorted
    by name (12 hex digits of sha256 over each file's name, length and
    bytes)."""
    source_dir = SOURCE_DIR if source_dir is None else source_dir
    h = hashlib.sha256()
    for path in [source_dir / f"{name}.cu", *sorted(source_dir.glob("*.cuh"))]:
        data = path.read_bytes()
        h.update(f"{path.name}\0{len(data)}\0".encode())
        h.update(data)
    return h.hexdigest()[:12]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if its library for the current
    :func:`source_digest` is not built yet) and return the library path."""
    src = SOURCE_DIR / f"{name}.cu"
    digest = source_digest(name)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log = out.with_suffix(".log")
    if out.exists():
        if log.exists():
            BUILD_LOG[name] = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    report = (proc.stdout + proc.stderr).strip()
    BUILD_LOG[name] = report
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {src.name} "
                           f"(exit {proc.returncode}):\n{report}")
    print(f"[build {name}] {' '.join(cmd)}\n{report}", file=sys.stderr)
    log.write_text(report)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
