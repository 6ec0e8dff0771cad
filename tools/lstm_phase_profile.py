#!/usr/bin/env python3
"""Where a step of the fused-LSTM cluster kernels (#4, #5) spends its time.

Run from the repository root on a host with one NVIDIA GPU:

    python3 tools/lstm_phase_profile.py [--H 256] [--T 50] [--batch 8 128]

It builds ``deeplearning4j_tpu_torch/csrc/fused_lstm_{fwd,bwd}.cu`` with
``-DLSTM_PHASE_PROFILE`` into ``build/phase_profile/``, where thread 0 of
block 0 (cluster 0, CTA 0) reads ``%globaltimer`` at each of the kernels'
``LSTM_PHASE`` marks (``csrc/lstm_common.cuh``) of every step, puts the
two libraries in the wrappers' place and prints one JSON line per (kernel,
dtype, B) with the call's time (CUDA events), the mean time of a step and
its split into phases, in microseconds, averaged over the steps but the
first and last. The timer reads add a few instructions a step: the split
says where the time goes; the kernels' own times come from chip_smoke.py.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from deeplearning4j_tpu_torch.ops import _build  # noqa: E402
from deeplearning4j_tpu_torch.ops import fused_lstm as fl  # noqa: E402

OUT = REPO / "build" / "phase_profile"
STEPS, MARKS = 64, 8   # the timer slots of csrc/lstm_common.cuh

# the phases ending at marks 1, 2, ... of each kernel's step (mark 0 starts it)
FWD_PHASES = ("product", "cell_update", "push_h", "barrier")
BWD_PHASES = ("cell_update", "push_dz", "barrier", "product", "sum_parts")


def build(name: str) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-DLSTM_PHASE_PROFILE", f"-I{_build.SOURCE_DIR}",
                    "-o", str(lib), str(_build.SOURCE_DIR / f"{name}.cu")], check=True)
    return lib


def load(lib_path: Path, name: str, n_ptr: int):
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    getattr(lib, name).argtypes = [ptr] * n_ptr + [i32] * 5 + [ptr]
    getattr(lib, name).restype = i32
    getattr(lib, f"{name}_error_string").argtypes = [i32]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    lib.lstm_phase_read.argtypes = [ptr]
    if name == "fused_lstm_bwd":
        lib.fused_lstm_bwd_workspace.argtypes = [i32] * 4
        lib.fused_lstm_bwd_workspace.restype = i64
    return lib


def phases(lib, names, T: int) -> dict:
    buf = np.zeros(STEPS * MARKS, np.uint64)
    lib.lstm_phase_read(buf.ctypes.data)
    g = buf.reshape(STEPS, MARKS).astype(np.int64)[:min(T, STEPS)]
    steps = g[1:-1]   # the first and last steps do less
    split = np.diff(steps[:, :len(names) + 1], axis=1).mean(0) / 1e3
    per_step = np.abs(np.diff(g[:, 0])).mean() / 1e3
    out = {"step_us": float(per_step)}
    out.update({name: float(v) for name, v in zip(names, split)})
    return out


def timed(fn, iters=10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--H", type=int, default=256)
    ap.add_argument("--T", type=int, default=50)
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 128])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lstm_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fl._fwd_lib = load(build("fused_lstm_fwd"), "fused_lstm_fwd", 11)
    fl._bwd_lib = load(build("fused_lstm_bwd"), "fused_lstm_bwd", 15)
    H, T = args.H, args.T
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("fwd", "bwd"):
            if fl.lstm_route(H, dtype, kind)[0] != "cluster":
                raise SystemExit(f"H={H} {dtype} takes the wide route for {kind}")
        for B in args.batch:
            r = lambda *s, k=1.0: torch.randn(*s, generator=g, device="cuda") * k  # noqa: E731
            zx, wh = r(B, T, 4 * H, k=0.5).to(dtype), r(H, 4 * H, k=H ** -0.5).to(dtype)
            h0, c0, peep = r(B, H, k=0.5).to(dtype), r(B, H, k=0.5).to(dtype), r(3 * H, k=0.3)
            fargs = (zx, wh, h0, c0, None, peep.to(dtype))
            ms = timed(lambda: fl.fused_lstm_fwd_cuda(*fargs))
            row = {"kernel": "fused_lstm_fwd", "dtype": str(dtype).split(".")[-1], "B": B,
                   "T": T, "H": H, "call_ms": ms,
                   **phases(fl._fwd_lib, FWD_PHASES, T)}
            print(json.dumps(row), flush=True)
            hs, gates, cs, _, _ = fl.fused_lstm_fwd_cuda(*fargs)
            cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, h0, c0, None, r(B, T, H), r(B, H))
            bargs = (gates, cs, cprev, hprev, wh, m, dhs, r(B, H), peep.to(dtype))
            ms = timed(lambda: fl.fused_lstm_bwd_cuda(*bargs))
            row = {"kernel": "fused_lstm_bwd", "dtype": str(dtype).split(".")[-1], "B": B,
                   "T": T, "H": H, "call_ms": ms,
                   **phases(fl._bwd_lib, BWD_PHASES, T)}
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
