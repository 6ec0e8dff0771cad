"""Native host-side data-loading parsers (C++ via ctypes; PyTorch port of
``deeplearning4j_tpu/native``).

Single-pass CSV and IDX parsers compiled from ``fastload.cpp`` (a copy of
the JAX package's source) with the system ``g++`` at first use, never at
import. The library goes to ``build/`` at the repository root (git-ignored)
under a name keyed by the source's digest, so an edited source rebuilds; the
JAX package caches its library next to its source instead.

The API is the JAX package's: :func:`get_lib` and :func:`available` return
None / False when no compiler is present or the build fails, and the callers
(``datasets/fetchers.py``, ``datasets/records.py``) then take their Python
paths. What happened is on record: :data:`BUILD_ERROR` holds the failed
build's message, :func:`lib_path` the library's path, and :data:`CALLS`
counts the parses that went through the library, so a caller that must not
fall back (``chip_smoke.py``) can check that it did not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["BUILD_DIR", "BUILD_ERROR", "CALLS", "available", "get_lib", "lib_path",
           "parse_csv", "parse_idx_images"]

_SRC = Path(__file__).resolve().parent / "fastload.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_path: Optional[Path] = None
_tried = False
BUILD_ERROR: Optional[str] = None
CALLS: Dict[str, int] = {"parse_csv": 0, "parse_idx_images": 0}


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfastload-{digest}.so"


def _build() -> Optional[Path]:
    global BUILD_ERROR
    if not _SRC.exists():
        BUILD_ERROR = f"{_SRC} is missing"
        return None
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a process-unique temporary name, then an atomic rename: concurrent
    # builders never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
                        "-o", str(tmp)], check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", None)
        BUILD_ERROR = f"{type(e).__name__}: {e}" + (
            f"\n{err.decode(errors='replace')}" if err else "")
        try:
            tmp.unlink()
        except OSError:
            pass
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, built on the first call; None when no toolchain
    is available or the library fails to load (callers must fall back)."""
    global _lib, _path, _tried, BUILD_ERROR
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            # graftlint: disable=retrace-hazard; the C++ parsers (no kernel), loaded once into _lib
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            BUILD_ERROR = f"load {path}: {e}"
            return None
        lib.parse_csv_f64.restype = ctypes.c_int
        lib.parse_csv_f64.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_char,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.parse_idx_images.restype = ctypes.c_int
        lib.parse_idx_images.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        _lib, _path = lib, path
        return _lib


def available() -> bool:
    return get_lib() is not None


def lib_path() -> Optional[Path]:
    """Where the loaded library lives (None before a successful build)."""
    return _path


def parse_csv(data: bytes, *, skip_lines: int = 0,
              delimiter: str = ",") -> Optional[np.ndarray]:
    """Numeric CSV bytes -> [rows, cols] float64, or None if the native lib
    is unavailable. Raises ValueError on malformed input (ragged rows,
    non-numeric fields) — same contract as the Python path."""
    lib = get_lib()
    if lib is None:
        return None
    # capacity: every field needs >= 2 bytes ("x,"), so len/2+1 bounds it
    max_vals = len(data) // 2 + 2
    out = np.empty(max_vals, np.float64)
    n_rows = ctypes.c_int64(0)
    n_cols = ctypes.c_int64(0)
    rc = lib.parse_csv_f64(
        data, len(data), skip_lines, delimiter.encode()[0:1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_vals,
        ctypes.byref(n_rows), ctypes.byref(n_cols))
    if rc == 2:
        raise ValueError("native CSV parse: ragged rows")
    if rc == 3:
        raise ValueError("native CSV parse: non-numeric or empty field")
    if rc == 4:
        raise ValueError("native CSV parse: field too long")
    if rc != 0:
        raise ValueError(f"native CSV parse failed (code {rc})")
    with _lock:
        CALLS["parse_csv"] += 1
    r, c = n_rows.value, n_cols.value
    return out[:r * c].reshape(r, c).copy()


def parse_idx_images(data: bytes) -> Optional[np.ndarray]:
    """IDX image archive bytes -> [n, h, w] uint8, or None if unavailable.
    Raises ValueError on a bad magic/truncated payload."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(max(len(data) - 16, 1), np.uint8)
    cnt = ctypes.c_int64(0)
    h = ctypes.c_int64(0)
    w = ctypes.c_int64(0)
    rc = lib.parse_idx_images(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
        ctypes.byref(cnt), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"native IDX parse failed (code {rc})")
    with _lock:
        CALLS["parse_idx_images"] += 1
    n, hh, ww = cnt.value, h.value, w.value
    return out[:n * hh * ww].reshape(n, hh, ww).copy()
