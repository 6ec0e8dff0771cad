"""Runtime donation guard: an in-place step must keep every leaf it took.

Counterpart of ``deeplearning4j_tpu/analysis/donation_guard.py``. The JAX
step donates its params, updater state and layer state; the port's step
updates the same leaves in place (``nn/model.py``, ``nn/graph.py``,
``parallel/grads.py``). The static side (``rules.py`` ``use-after-donate``)
proves code does not *obviously* read a leaf as old after a step; this
module proves the step kept its half of the contract. A step that REBINDS a
leaf (a new tensor in the model's tree where the old one was) leaves every
other holder of the old tensor reading stale values: the updater state, an
``AotFunction`` snapshot, a ParallelWrapper replica, a decode program's
weight view. Nothing fails; the answers are silently wrong. That is the
port's form of a use-after-donate.

Under ``DL4J_TPU_DONATION_GUARD=1`` the stateful sites (``nn/aot.py``'s
training-step sites, the data-parallel step) take a :func:`snapshot` of
every param, updater-state and layer-state leaf before the step and run
:func:`check_after_step` after it. A leaf whose storage changed
(``data_ptr()``) is a trip: it counts in ``dl4j_donation_guard_trips_total``,
raises one ``donation_guard`` obs event per site, and its orphaned old
tensor is filled with NaN (the port's ``jax.Array.delete()``), so any stale
read shows. Leaves that stayed are split by their ``_version``: advanced
(the step wrote them) or not. Both checks read host metadata only; no
value moves to the CPU.

Opt-in, as the retrace guard: poisoning is the point, a debug mode for
tests and repros, never a default. Off, :func:`snapshot` returns None after
one environment read.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

__all__ = [
    "GuardTrip",
    "KINDS",
    "StepReport",
    "StepSnapshot",
    "TRIPS_COUNTER",
    "check_after_step",
    "enabled",
    "reset_warnings",
    "snapshot",
]

TRIPS_COUNTER = "dl4j_donation_guard_trips_total"

# the model attributes whose leaves a step updates in place
KINDS = ("params", "opt_state", "state")

_trips = obs.counter(
    TRIPS_COUNTER,
    "leaves an in-place step rebound (their old tensors poisoned with NaN) "
    "under the donation guard")


def enabled() -> bool:
    return os.environ.get("DL4J_TPU_DONATION_GUARD", "0") != "0"


@dataclass(frozen=True)
class GuardTrip:
    """One leaf a step rebound (its old tensor now NaN)."""

    site: str
    kind: str             # "params", "opt_state" or "state"
    position: int         # leaf index in treedef order within ``kind``
    shape: Tuple[int, ...]


@dataclass
class StepSnapshot:
    """The leaves a step took: (kind, position, tensor, data_ptr, _version)."""

    site: str
    leaves: List[Tuple[str, int, Any, int, int]] = field(default_factory=list)


@dataclass(frozen=True)
class StepReport:
    """What one step did to the leaves it took."""

    site: str
    trips: Tuple[GuardTrip, ...]
    advanced: int         # kept and written (``_version`` advanced)
    unchanged: int        # kept and not written


# one obs event per site per process; tests reset between cases
_evented: Set[str] = set()
_evented_lock = threading.Lock()


def reset_warnings() -> None:
    with _evented_lock:
        _evented.clear()


def _tensor_leaves(model, kind: str) -> list:
    import torch

    return [t for t in tree_leaves(getattr(model, kind, None))
            if isinstance(t, torch.Tensor)]


def snapshot(model, site: str) -> Optional[StepSnapshot]:
    """The leaves ``model``'s step is about to take, or None when the guard
    is off (the one check a disabled guard costs)."""
    if not enabled():
        return None
    snap = StepSnapshot(site)
    for kind in KINDS:
        for i, t in enumerate(_tensor_leaves(model, kind)):
            snap.leaves.append((kind, i, t, t.data_ptr(), t._version))
    return snap


def _poison(t) -> None:
    import torch

    if not (t.is_floating_point() or t.is_complex()):
        return
    with torch.no_grad():
        if t.is_inference():
            with torch.inference_mode():
                t.fill_(float("nan"))
        else:
            t.fill_(float("nan"))


def check_after_step(snap: Optional[StepSnapshot], model) -> Optional[StepReport]:
    """Compare ``model``'s leaves after the step with ``snap``. Every leaf
    that no longer sits in its place with its storage is a trip: counted,
    evented once per site, and its old tensor filled with NaN. A leaf kind
    that did not exist before the step (updater state made by the first
    update) has nothing to compare."""
    if snap is None:
        return None
    after = {kind: _tensor_leaves(model, kind) for kind in KINDS}
    live = {t.data_ptr() for ts in after.values() for t in ts}
    trips: List[GuardTrip] = []
    advanced = unchanged = 0
    for kind, i, old, ptr, version in snap.leaves:
        now = after[kind]
        new = now[i] if i < len(now) else None
        if new is not None and new.data_ptr() == ptr:
            if new._version > version:
                advanced += 1
            else:
                unchanged += 1
            continue
        trips.append(GuardTrip(snap.site, kind, i, tuple(old.shape)))
        _trips.inc()
        if ptr not in live:     # moved, not orphaned: the model still reads it
            _poison(old)
    if trips:
        with _evented_lock:
            first = snap.site not in _evented
            _evented.add(snap.site)
        if first:
            obs.event("donation_guard", site=snap.site, rebound=len(trips),
                      kinds=sorted({t.kind for t in trips}))
    return StepReport(snap.site, tuple(trips), advanced, unchanged)
