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

Each build writes a stamp beside its library (``<lib>.stamp``: the
source digest and the library's sha256). ``utils/compile_cache.py`` points
``BUILD_DIR`` at a cache shared between processes or checkouts; a library
found there is loaded only when its stamp matches (:data:`VERIFY_STAMPS`),
else it is rebuilt. ``DL4J_TPU_COMPILE_CACHE`` is read at the first build.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
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
# set by utils/compile_cache.py: load a library only when its stamp matches
VERIFY_STAMPS = False
# the names of the libraries this process ran nvcc for
NVCC_RUNS: list = []
_ENV_READ = False
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


def _file_sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def stamp_ok(lib: Path, digest: str) -> bool:
    """Does the stamp beside ``lib`` name ``digest`` and the library's own
    sha256?"""
    try:
        st = json.loads(lib.with_suffix(".stamp").read_text())
        return st.get("digest") == digest and st.get("sha256") == _file_sha256(lib)
    except (OSError, ValueError):
        return False


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if its library for the current
    :func:`source_digest` is not built yet) and return the library path."""
    # graftlint: disable=jit-purity; read the cache knob once per process
    global _ENV_READ
    if not _ENV_READ:
        _ENV_READ = True
        from deeplearning4j_tpu_torch.utils.compile_cache import (
            enable_compilation_cache_from_env)

        enable_compilation_cache_from_env()
    src = SOURCE_DIR / f"{name}.cu"
    digest = source_digest(name)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log = out.with_suffix(".log")
    if out.exists() and (not VERIFY_STAMPS or stamp_ok(out, digest)):
        if log.exists():
            # graftlint: disable=jit-purity,retrace-hazard,lock-discipline; under load()'s _LOCK
            BUILD_LOG[name] = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    # graftlint: disable=jit-purity,retrace-hazard,lock-discipline; under load()'s _LOCK
    NVCC_RUNS.append(name)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    report = (proc.stdout + proc.stderr).strip()
    # graftlint: disable=jit-purity,retrace-hazard,lock-discipline; under load()'s _LOCK
    BUILD_LOG[name] = report
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {src.name} "
                           f"(exit {proc.returncode}):\n{report}")
    print(f"[build {name}] {' '.join(cmd)}\n{report}", file=sys.stderr)
    log.write_text(report)
    stamp = out.with_suffix(f".stamp.tmp{os.getpid()}")
    stamp.write_text(json.dumps({"digest": digest, "sha256": _file_sha256(tmp)}))
    os.replace(tmp, out)
    os.replace(stamp, out.with_suffix(".stamp"))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        # graftlint: disable=retrace-hazard; the library cache, read under _LOCK
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            # graftlint: disable=jit-purity,retrace-hazard; the library cache: one load per process
            _LIBS[name] = lib
        return lib
