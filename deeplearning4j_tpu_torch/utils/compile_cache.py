"""Persistent kernel-library cache — a second process builds nothing.

Counterpart of ``deeplearning4j_tpu/utils/compile_cache.py``. What the
port compiles is its hand-written CUDA kernels: ``ops/_build.py`` runs
``nvcc`` on each ``csrc/*.cu`` at first use and keeps the library in
``BUILD_DIR`` under a name keyed by the sources' digest. Pointing that
directory at a shared cache lets another process, or another checkout of
the same sources, load the ``.so`` files instead of running ``nvcc``.

Opt-in, as in the JAX package:

    from deeplearning4j_tpu_torch.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache("/path/to/cache")   # ~/.cache/deeplearning4j_tpu_torch/kernels

or set ``DL4J_TPU_COMPILE_CACHE=/path`` (empty value = the default dir):
the first kernel build of the process reads it
(:func:`enable_compilation_cache_from_env`).

A cached library is loaded only when the stamp ``_build`` wrote beside it
at build time names the same source digest and the library's own sha256
still matches; anything else is rebuilt from the checkout's sources.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["enable_compilation_cache", "enable_compilation_cache_from_env"]

_DEFAULT = os.path.join(os.path.expanduser("~"), ".cache",
                        "deeplearning4j_tpu_torch", "kernels")


def enable_compilation_cache(cache_dir: Optional[str] = None,
                             min_compile_time_secs: float = 1.0) -> str:
    """Point the kernel build directory at ``cache_dir`` (created if
    missing) and verify every library found there against its stamp.
    ``min_compile_time_secs`` is kept for the JAX package's signature: every
    kernel library is worth keeping."""
    from deeplearning4j_tpu_torch.ops import _build

    path = cache_dir or _DEFAULT
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    _build.VERIFY_STAMPS = True
    return path


def enable_compilation_cache_from_env() -> Optional[str]:
    """Enable the cache iff DL4J_TPU_COMPILE_CACHE is set (empty value =
    default location). Returns the directory or None."""
    val = os.environ.get("DL4J_TPU_COMPILE_CACHE")
    if val is None:
        return None
    return enable_compilation_cache(val or None)
