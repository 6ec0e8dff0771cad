"""Runtime retrace guard: new signatures must match the bucket ladder.

Counterpart of ``deeplearning4j_tpu/analysis/retrace_guard.py``. Static
analysis (``rules.py``) proves the code can't easily regress into a new
signature per call; this module proves the *process* didn't. PyTorch
compiles no executable, so a "compile" is the first dispatch of a new
signature at a site (``nn/aot.py`` records it through
``bucketing.record_trace``): the cold-shape cost a new shape pays on the
card, and what a CUDA-graph capture would have to capture. The bucketing
telemetry counts those and the bucket hits per dispatch, so the ladder
predicts an upper bound: a site should see **at most one new signature per
distinct bucket its traffic used**, plus the buckets warmed ahead of time.
More means something varied beyond the leading dim: an unpadded sequence
length, a fresh wrapper, a value-keyed argument that changes per call.

Checks are opt-in (telemetry is process-global, so unrelated models sharing
a site would trip false alarms in ordinary runs):

- ``DL4J_TPU_RETRACE_GUARD=1``  enable checks; violations warn once per site
- ``DL4J_TPU_STRICT_RETRACE=1`` enable checks; violations raise RetraceError

``nn/aot.py``'s sites call ``check_if_enabled(...)`` after each dispatch;
``RetraceGuard`` wraps a plain torch function with the same signature and
hit accounting and the same bound check. Off, a check reads two
environment variables and nothing else; on, it reads host counters only
and never touches a tensor's values.
"""

from __future__ import annotations

import os
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.utils import bucketing

__all__ = [
    "GuardReport",
    "RetraceError",
    "RetraceGuard",
    "RetraceWarning",
    "Signatures",
    "aot_warmed_buckets",
    "check",
    "check_if_enabled",
    "enabled",
    "predicted_compiles",
    "register_aot_warmed",
    "reset_aot_warmed",
    "reset_warnings",
    "signature_of",
    "strict",
]


class RetraceError(RuntimeError):
    """A site saw more new signatures than its bucket ladder predicts."""


class RetraceWarning(UserWarning):
    """Non-strict flavor of :class:`RetraceError`."""


def strict() -> bool:
    return os.environ.get("DL4J_TPU_STRICT_RETRACE", "0") != "0"


def enabled() -> bool:
    return strict() or os.environ.get("DL4J_TPU_RETRACE_GUARD", "0") != "0"


@dataclass(frozen=True)
class GuardReport:
    """Outcome of one bound check. ``predicted`` is None when the site has
    no recorded bucket traffic yet (nothing to bound against)."""

    site: str
    compiles: int
    predicted: Optional[int]
    ok: bool


# one warning per site per process; tests reset between cases
_warned: Set[str] = set()
_warned_lock = threading.Lock()


def reset_warnings() -> None:
    with _warned_lock:
        _warned.clear()


# AOT cross-registration (nn/aot.py's warmers): buckets warmed ahead of time
# have a legitimate first dispatch each even before any traffic hits them,
# so the predicted bound below unions warmed buckets with observed traffic.
# Conversely the warm enumerates the SAME ladder the guard bounds against
# (``aot.reachable_buckets``), so the two cross-check: warming a bucket the
# guard never sees traffic for is accounted, and traffic in a bucket the
# warm failed to enumerate shows up as a lazy compile within the bound.
_aot_warmed: dict = {}
_aot_lock = threading.Lock()


def register_aot_warmed(site: str, buckets) -> None:
    """Record that ``site`` was warmed for ``buckets`` (leading-dim rungs),
    extending the predicted compile bound accordingly."""
    with _aot_lock:
        _aot_warmed.setdefault(site, set()).update(int(b) for b in buckets)


def aot_warmed_buckets(site: str) -> frozenset:
    with _aot_lock:
        return frozenset(_aot_warmed.get(site, ()))


def reset_aot_warmed() -> None:
    with _aot_lock:
        _aot_warmed.clear()


def predicted_compiles(site: str, hits_site: Optional[str] = None) -> Optional[int]:
    """Ladder-predicted compile bound for ``site``: the number of distinct
    buckets its traffic hit, unioned with buckets warmed for the site
    (``register_aot_warmed``). Trace and hit counters may live under
    different site names (e.g. traces at ``mln.step``, hits at ``mln.fit``)
    — ``hits_site`` names the hit counter when they differ."""
    used = set(bucketing.telemetry().buckets_used(hits_site or site))
    used |= aot_warmed_buckets(site)
    if hits_site:
        used |= aot_warmed_buckets(hits_site)
    return len(used) if used else None


def check(site: str, hits_site: Optional[str] = None,
          extra_allowed: int = 0) -> GuardReport:
    """Compare observed compiles at ``site`` against the ladder bound.
    Violations raise :class:`RetraceError` under ``DL4J_TPU_STRICT_RETRACE=1``
    and otherwise emit one :class:`RetraceWarning` per site."""
    tel = bucketing.telemetry()
    compiles = tel.compiles(site)
    predicted = predicted_compiles(site, hits_site)
    ok = predicted is None or compiles <= predicted + extra_allowed
    report = GuardReport(site, compiles, predicted, ok)
    if not ok:
        from deeplearning4j_tpu_torch import obs

        buckets = tel.buckets_used(hits_site or site)
        obs.event("retrace_guard", site=site, compiles=compiles,
                  predicted=predicted, buckets=sorted(buckets))
        msg = (
            f"retrace guard: site '{site}' compiled {compiles}x but its "
            f"traffic used only {predicted} bucket(s) {list(buckets)}"
            + (f" (+{extra_allowed} allowed)" if extra_allowed else "")
            + " — something retraces beyond the bucket ladder (unpadded "
            "shape, a value-keyed argument that changes per call, or a fresh "
            "wrapper per call)"
        )
        if strict():
            raise RetraceError(msg)
        with _warned_lock:
            first = site not in _warned
            _warned.add(site)
        if first:
            warnings.warn(msg, RetraceWarning, stacklevel=2)
    return report


def check_if_enabled(site: str, hits_site: Optional[str] = None,
                     extra_allowed: int = 0) -> Optional[GuardReport]:
    """No-op unless the guard env knobs are set — the hook the dispatch
    sites call unconditionally."""
    if not enabled():
        return None
    return check(site, hits_site, extra_allowed=extra_allowed)


def _leading_dim(args: Sequence[Any], skip: Tuple[int, ...]) -> Optional[int]:
    for i, a in enumerate(args):
        if i in skip:
            continue
        shape = getattr(a, "shape", None)
        if shape is not None and len(shape) >= 1:
            return int(shape[0])
    return None


def _sig(x) -> Any:
    """Hashable signature of one argument: a tensor's or an array's
    (shape, dtype, device type), containers element by element, any other
    value itself (it must be hashable; a value that hashes fresh per
    instance is a new signature every call, as a fresh static argument is
    a new trace under jit)."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        dev = getattr(x, "device", None)
        return ("t", tuple(int(s) for s in shape), str(dtype),
                getattr(dev, "type", None))
    if isinstance(x, (tuple, list)):
        return ("s", tuple(_sig(v) for v in x))
    if isinstance(x, dict):
        return ("d", tuple((k, _sig(x[k])) for k in sorted(x)))
    hash(x)
    return ("v", x)


def signature_of(*args, **kwargs) -> Any:
    """Hashable signature of a call's arguments (see ``_sig``)."""
    return (_sig(tuple(args)), _sig(kwargs))


class Signatures:
    """The signatures dispatched at sites that no model owns (the k-means
    steps, a :class:`RetraceGuard`): the first dispatch of each records a
    compile at its site (``bucketing.record_trace``). A model's sites keep
    theirs in ``nn/aot.py``'s ``AotFunction``."""

    def __init__(self):
        self._seen: Set[Any] = set()
        self._lock = threading.Lock()

    def note(self, site: str, key: Any, shape: Sequence[int] = ()) -> bool:
        """Record ``key`` at ``site``; True (and one compile) when new."""
        with self._lock:
            new = (site, key) not in self._seen
            self._seen.add((site, key))
        if new:
            bucketing.telemetry().record_trace(site, shape)
        return new


class RetraceGuard:
    """Signature and bucket accounting + bound check for a standalone torch
    function.

    ``RetraceGuard(fn, site)`` calls ``fn`` as it is (PyTorch runs eagerly)
    and, around every call, records a bucket hit (by the first
    non-``static_argnums`` argument's leading dim, rounded up the ladder),
    a compile the first time a signature is seen (``_sig`` of every
    argument), and then the bound check via ``check_if_enabled``.
    ``static_argnums`` only exempts those arguments from the leading-dim
    pick, as the reference's jit-static arguments are."""

    def __init__(self, fn: Callable, site: str,
                 static_argnums: Sequence[int] = (),
                 ladder: Optional[bucketing.BucketLadder] = None):
        self._fn = fn
        self.site = site
        self._static = tuple(static_argnums)
        self._ladder = ladder
        self._sigs = Signatures()

    def __call__(self, *args, **kwargs):
        n = _leading_dim(args, self._static)
        if n is not None:
            bucketing.telemetry().record_hit(
                self.site, n, bucketing.bucket_size(n, self._ladder))
        self._sigs.note(self.site, signature_of(*args, **kwargs),
                        (n,) if n is not None else ())
        out = self._fn(*args, **kwargs)
        check_if_enabled(self.site)
        return out

    @property
    def report(self) -> GuardReport:
        """Current bound check without warning/raising."""
        tel = bucketing.telemetry()
        compiles = tel.compiles(self.site)
        predicted = predicted_compiles(self.site)
        ok = predicted is None or compiles <= predicted
        return GuardReport(self.site, compiles, predicted, ok)
