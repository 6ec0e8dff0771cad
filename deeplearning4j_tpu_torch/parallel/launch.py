"""Start a small local world of rank processes and join them under one
deadline (the launcher the parallel smoke phases and tests use; a host
with several cards uses ``torchrun``).

:func:`spawn_ranks` runs ``argv + [rank, world, root]`` once per rank with
its output in ``root/rank<r>.log``. When the deadline passes every rank is
killed and :class:`RankTimeout` is raised; as soon as a rank exits
non-zero the others are killed (they would wait in a collective) and
:class:`RankFailed` is raised. Either carries the tail of the log at fault.
A rank rendezvouses through ``file://<root>/store`` (``init_distributed``),
so concurrent worlds never share a port.
"""

from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["RankFailed", "RankTimeout", "spawn_ranks"]


class RankTimeout(RuntimeError):
    """The ranks did not all finish before the deadline (they were killed)."""


class RankFailed(RuntimeError):
    """A rank exited with a non-zero code."""


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def spawn_ranks(argv: Sequence[str], world: int, root, timeout_s: float,
                env: Optional[Dict[str, str]] = None, cwd=None) -> float:
    """Run ``world`` processes ``argv + [rank, world, root]`` and wait for all
    of them within ``timeout_s`` seconds; returns the seconds they took.
    Gloo binds to the loopback device unless ``GLOO_SOCKET_IFNAME`` says
    otherwise."""
    root = Path(root)
    env = dict(os.environ if env is None else env)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    t0 = time.monotonic()
    try:
        for r in range(world):
            log = open(root / f"rank{r}.log", "w")
            procs.append((subprocess.Popen([*argv, str(r), str(world), str(root)], cwd=cwd,
                                           env=env, stdout=log, stderr=subprocess.STDOUT), log))
        deadline = t0 + timeout_s
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RankFailed(f"rank {bad[0]} exited {codes[bad[0]]}:\n"
                                 + _tail(root / f"rank{bad[0]}.log"))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RankTimeout(f"{world} ranks did not finish within {timeout_s} s:\n"
                                  + _tail(root / "rank0.log"))
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return time.monotonic() - t0
