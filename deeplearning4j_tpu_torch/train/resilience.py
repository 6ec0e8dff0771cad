"""Fault-tolerant training runtime (PyTorch port of the single-process part
of ``deeplearning4j_tpu/train/resilience.py``): durable checkpoints,
resume, the divergence guard and the chaos harness.

- ``save_checkpoint`` / ``validate_checkpoint``: atomic zip writes (tmp +
  fsync + ``os.replace`` in utils/serialization.py) with the CRC32 and size
  of the final bytes recorded in ``checkpointInfo.json``, so a checkpoint
  is whole or provably bad.
- ``resume(model, dir)``: load the newest VALID checkpoint (a corrupt or
  truncated file falls back to the previous valid one) into an existing
  model: params, optimizer state, layer state, iteration and epoch, the
  model's ``torch.Generator`` state, the position in the epoch and the LR
  scale. ``fit(..., resume_from=dir)`` drives it and skips the batches the
  interrupted epoch already used, so an interrupted and resumed run draws
  the same random numbers and sees the same batches as an uninterrupted
  one, and ends with the same bits.
- ``DivergenceGuard``: non-finite and loss-spike detection. Its
  ``skip_batch`` policy is applied inside the step: the update is computed
  out of place and ``torch.where(ok, new, old)`` on a device bool keeps or
  drops it (params, updater state, layer state), with no read of the loss
  on the host. warn and skip_batch read the scores in windows of
  ``flush_every`` as one stacked copy; ``rollback`` reloads the last valid
  checkpoint and backs the LR off.
- Chaos harness: ``DL4J_TPU_CHAOS=preempt@iter:8,corrupt_ckpt@ckpt:1:bitflip``
  (grammar in ``ChaosInjector``) for the faults ``preempt``, ``nan_grad``,
  ``slow_iter`` and ``corrupt_ckpt``, and the distributed ones that the
  elastic trainer (``train/elastic.py``) consults at its step boundary:
  ``host_kill``, ``net_partition``, ``slice_kill`` and ``rack_partition``.
  Deterministic and one-shot.
- ``load_distributed_checkpoint``: the elastic trainer's layout (per-rank
  shard files, a replicated params file and a CRC'd manifest written last,
  the commit point); the same files as the JAX package's, read by either.

While a data-parallel exchange is active (``parallel/grads.py``
``DataParallelStep``, ``model._dp_runner``), a checkpoint takes its
optimizer state out of the exchange's layout and stores the compression
residuals of every rank (a collective: every rank saves, each into its own
directory in a multi-process run). Beside each checkpoint ``save_checkpoint``
writes the model's warm-set bundle (``nn/aot.py``, ``<path>.aotbundle``:
the signatures its sites ran and their costs) and ``resume`` restores it,
so the first step after a resume meets no cold shape.
"""

from __future__ import annotations

import glob
import io
import json
import math
import os
import signal
import time
import warnings
import zipfile
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.utils import bucketing

__all__ = [
    "ChaosInjector",
    "ChaosPreemption",
    "DivergenceError",
    "DivergenceGuard",
    "active_chaos",
    "capture_train_state",
    "corrupt_file",
    "crc32_file",
    "guard_ok",
    "install_chaos",
    "io_with_retries",
    "load_distributed_checkpoint",
    "load_state_into",
    "note_score",
    "resume",
    "save_checkpoint",
    "validate_checkpoint",
    "write_bytes_durable",
    "write_json_durable",
]


# ---------------------------------------------------------------------------
# Retrying I/O: bounded exponential backoff for checkpoint reads/writes
# ---------------------------------------------------------------------------


def _retry_knobs():
    return (int(os.environ.get("DL4J_TPU_CKPT_RETRIES", "3")),
            float(os.environ.get("DL4J_TPU_CKPT_RETRY_BASE_S", "0.05")),
            float(os.environ.get("DL4J_TPU_CKPT_RETRY_CAP_S", "2.0")))


def io_with_retries(fn: Callable[[], Any], *, what: str = "ckpt_io"):
    """Run a checkpoint I/O callable, retrying ``OSError`` with bounded
    exponential backoff (``DL4J_TPU_CKPT_RETRIES`` attempts beyond the
    first, delay ``base * 2**k`` capped at ``DL4J_TPU_CKPT_RETRY_CAP_S``).
    Each retry increments ``dl4j_ckpt_retries_total``; exhaustion re-raises
    the last error."""
    retries, base, cap = _retry_knobs()
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            delay = min(base * (2 ** attempt), cap)
            obs.counter("dl4j_ckpt_retries_total",
                        "Checkpoint I/O operations retried after a "
                        "transient OSError").inc()
            obs.event("ckpt_io_retry", what=what, attempt=attempt + 1,
                      error=str(e), delay_s=round(delay, 4))
            time.sleep(delay)


def write_bytes_durable(path, data: bytes) -> None:
    """Atomic durable byte write (tmp + fsync + ``os.replace``) with retry
    backoff."""

    def attempt():
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    io_with_retries(attempt, what=f"write:{os.path.basename(str(path))}")


def write_json_durable(path, value) -> None:
    write_bytes_durable(path, json.dumps(value, indent=1).encode("utf-8"))


# ---------------------------------------------------------------------------
# Durable checkpoints: CRC + validation + newest-valid fallback
# ---------------------------------------------------------------------------


def crc32_file(path, chunk: int = 1 << 20) -> int:
    """CRC32 of a file's bytes, streamed (checkpoints can be large)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def validate_checkpoint(path, crc: Optional[int] = None,
                        size: Optional[int] = None) -> bool:
    """True when the checkpoint file at ``path`` is intact.

    With a recorded ``crc``/``size`` (checkpointInfo.json entries) the check
    is exact: truncation changes the size, bit flips change the CRC. Entries
    without a CRC fall back to a structural zip check (central directory,
    per-entry CRCs, the required entries present)."""
    try:
        if not os.path.isfile(path):
            return False
        if size is not None and os.path.getsize(path) != int(size):
            return False
        if crc is not None:
            return crc32_file(path) == int(crc)
        from deeplearning4j_tpu_torch.utils import serialization as S

        with zipfile.ZipFile(path, "r") as zf:
            if zf.testzip() is not None:
                return False
            names = set(zf.namelist())
            return S.CONFIG_ENTRY in names and S.COEFFICIENTS_ENTRY in names
    except Exception:
        return False


def capture_train_state(model) -> dict:
    """The JSON-able training state a model zip alone does not carry: the
    model generator's state (the dropout and noise stream's position), the
    batch position in the epoch, the divergence guard's LR scale and the
    observability snapshot (informational: a restored run keeps its own
    counters).

    The generator's state goes under ``"torch_rng"`` (its bytes) and
    ``"torch_rng_device"`` (the generator's device type), never under
    ``"rng"``: the JAX package reads ``"rng"`` as a JAX PRNG key, and a
    torch state there would load as a garbage key."""
    state: Dict[str, Any] = {
        "version": 1,
        "batch_in_epoch": int(getattr(model, "batch_in_epoch", 0)),
        "lr_scale": float(getattr(model, "_lr_scale", 1.0)),
        "telemetry": obs.snapshot(),
    }
    gen = getattr(model, "_gen", None)
    if gen is not None:
        state["torch_rng"] = gen.get_state().tolist()
        state["torch_rng_device"] = gen.device.type
    return state


def save_checkpoint(model, path, normalizer: Optional[dict] = None) -> dict:
    """Durable full-state checkpoint: an atomic zip write and the CRC of
    the final bytes. Returns ``{"path", "crc", "size", "seconds"}`` for the
    checkpoint index, with ``"aot_bundle"`` when the warm-set sidecar was
    written (``nn/aot.py``: gated by ``DL4J_TPU_AOT_BUNDLE``, never
    raising — the checkpoint above is durable whatever happens to it)."""
    from deeplearning4j_tpu_torch.utils import serialization as S

    t0 = time.perf_counter()
    with obs.span("checkpoint.save"):
        opt_state = residuals = None
        runner = getattr(model, "_dp_runner", None)
        if runner is not None:
            if runner.active:
                opt_state = runner.snapshot_opt_state()
            residuals = runner.export_residuals() or None
        io_with_retries(
            lambda: S.save_network(model, path, normalizer=normalizer,
                                   train_state=capture_train_state(model),
                                   residuals=residuals, opt_state=opt_state),
            what=f"save_network:{os.path.basename(str(path))}")
        info = {"path": path, "crc": crc32_file(path),
                "size": os.path.getsize(path)}
    dur = time.perf_counter() - t0
    info["seconds"] = dur
    obs.counter("dl4j_checkpoint_saves_total",
                "Checkpoints written via save_checkpoint").inc()
    obs.histogram("dl4j_checkpoint_save_seconds",
                  "Wall time of durable checkpoint writes").observe(dur)
    obs.event("checkpoint_saved", path=str(path), crc=info["crc"],
              size=info["size"], duration_s=round(dur, 6))
    from deeplearning4j_tpu_torch.nn import aot

    bundle = aot.save_bundle(model, aot.bundle_path_for(path))
    if bundle is not None:
        info["aot_bundle"] = bundle
    return info


def load_state_into(model, path):
    """Load a checkpoint INTO an existing (config-compatible) model:
    params, state, optimizer state and the train-state extras. A leaf-count
    mismatch raises (config/checkpoint mismatch) rather than truncating."""
    from deeplearning4j_tpu_torch.utils import serialization as S

    t0 = time.perf_counter()
    with obs.span("checkpoint.restore"):
        if model.params is None:
            model.init()
        S.apply_snapshot(model, S.read_snapshot(path))
    dur = time.perf_counter() - t0
    obs.counter("dl4j_checkpoint_restores_total",
                "Checkpoints loaded via load_state_into/resume").inc()
    obs.histogram("dl4j_checkpoint_restore_seconds",
                  "Wall time of checkpoint restores").observe(dur)
    obs.event("checkpoint_restored", path=str(path), duration_s=round(dur, 6))
    return model


def resume(model, directory):
    """Restore ``model`` from the newest VALID checkpoint in ``directory``
    (corrupt or truncated files fall back to older valid ones). Returns the
    Checkpoint record, or None (with a warning) when the directory holds no
    valid checkpoint: training then starts from the model's current state.
    The checkpoint's warm-set sidecar is restored too (a missing one is a
    no-op; a corrupt or mismatched one is rejected, never raised)."""
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

    cp = CheckpointListener.last_valid_checkpoint(directory)
    if cp is None:
        obs.event("checkpoint_corrupt_fallback", directory=str(directory),
                  fallback="none")
        warnings.warn(
            f"resume_from={str(directory)!r}: no valid checkpoint found; "
            "training from the model's current state")
        return None
    path = os.path.join(str(directory), cp.filename)
    load_state_into(model, path)
    from deeplearning4j_tpu_torch.nn import aot

    aot.restore_bundle(model, aot.bundle_path_for(path))
    return cp


# ---------------------------------------------------------------------------
# Distributed checkpoints (the elastic trainer's layout)
# ---------------------------------------------------------------------------


def _read_npz(path, what: str) -> Dict[str, np.ndarray]:
    def read():
        with open(path, "rb") as f:
            return f.read()

    with np.load(io.BytesIO(io_with_retries(read, what=what)), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_distributed_checkpoint(directory) -> Optional[dict]:
    """Load the newest VALID distributed checkpoint from ``directory``.

    The elastic trainer's layout: per-rank shard files
    ``shard_<tag>_r<rank>.npz`` (each rank's optimizer segments — its
    primary 1/W slice AND the mirrors it carries — plus compression
    residuals), a replicated ``ckpt_<tag>_params.npz`` (params, dense
    updater state, layer state, meta), and a ``manifest_<tag>.json`` with
    per-file CRC32 + size written LAST by rank 0 — the commit point.

    Validation is per file: a manifest whose params file fails its CRC falls
    back to the next-older manifest; a corrupt *shard* file is dropped on
    its own, because every segment it held also lives in a mirror's shard —
    only the trainer can judge whether the surviving set covers every
    segment. Returns ``{"manifest", "params", "shards": {rank: arrays},
    "path"}`` or None.
    """
    directory = os.fspath(directory)
    manifests = sorted(glob.glob(os.path.join(directory, "manifest_*.json")),
                       reverse=True)
    for mpath in manifests:
        try:
            with open(mpath, "r") as f:
                man = json.load(f)
        except (OSError, ValueError):
            obs.event("checkpoint_corrupt_fallback", path=mpath,
                      reason="manifest unreadable")
            continue
        ppath = os.path.join(directory, man["params"]["file"])
        if not validate_checkpoint(ppath, crc=man["params"]["crc"],
                                   size=man["params"]["size"]):
            obs.event("checkpoint_corrupt_fallback", path=ppath,
                      reason="params file failed CRC/size")
            continue
        params = _read_npz(ppath, "read:params")
        shards: Dict[int, Dict[str, np.ndarray]] = {}
        for rank_s, meta in man.get("shards", {}).items():
            spath = os.path.join(directory, meta["file"])
            if not validate_checkpoint(spath, crc=meta["crc"], size=meta["size"]):
                obs.event("checkpoint_shard_dropped", path=spath,
                          rank=int(rank_s), reason="failed CRC/size")
                continue
            shards[int(rank_s)] = _read_npz(spath, f"read:shard{rank_s}")
        obs.event("distributed_checkpoint_loaded", path=mpath,
                  world=man.get("world"), shards=sorted(shards),
                  iteration=man.get("iteration"))
        return {"manifest": man, "params": params, "shards": shards,
                "path": mpath}
    return None


# ---------------------------------------------------------------------------
# Divergence guard
# ---------------------------------------------------------------------------


class DivergenceError(RuntimeError):
    """Raised when the rollback policy exhausts its retry budget (or has no
    valid checkpoint to roll back to)."""


def guard_ok(loss: torch.Tensor, spike_limit: Optional[float]) -> torch.Tensor:
    """The skip_batch predicate as a device bool: the step's candidate
    update is acceptable (finite loss, at most ``spike_limit``). Nothing is
    read back to the host."""
    ok = torch.isfinite(loss)
    if spike_limit is not None:
        ok = ok & (loss <= spike_limit)
    return ok


class DivergenceGuard:
    """Non-finite / loss-spike watchdog for fit loops.

    Policies (``InvalidScoreIterationTerminationCondition`` semantics,
    upgraded from terminate-only to recover):

    - ``warn``: count and warn once; training proceeds untouched.
    - ``skip_batch``: the step drops the bad update on the device
      (``guard_ok`` and ``torch.where`` over params, updater state and
      layer state); the host side only counts and warns. While it is on,
      a step holds the new and the old value of one layer's params and
      updater state at a time.
    - ``rollback``: reload the last valid checkpoint from
      ``checkpoint_dir``, multiply the LR by ``lr_backoff`` (compounding),
      and continue, at most ``max_retries`` times, then
      :class:`DivergenceError`.

    Host reads: warn and skip_batch read their scores in windows of
    ``flush_every`` device scalars (one stacked copy a window, and again at
    the end of an epoch), so the guard adds no read per step. rollback reads
    every step: it must act before the next update.

    Install with ``model.set_divergence_guard(guard)``.
    """

    POLICIES = ("warn", "skip_batch", "rollback")

    def __init__(self, policy: str = "warn", spike_limit: Optional[float] = None,
                 checkpoint_dir=None, lr_backoff: float = 0.5,
                 max_retries: int = 3, flush_every: int = 32):
        if policy not in self.POLICIES:
            raise ValueError(
                f"DivergenceGuard policy {policy!r} not in {self.POLICIES}")
        if policy == "rollback" and checkpoint_dir is None:
            raise ValueError(
                "DivergenceGuard(policy='rollback') needs checkpoint_dir=")
        self.policy = policy
        self.spike_limit = None if spike_limit is None else float(spike_limit)
        self.checkpoint_dir = checkpoint_dir
        self.lr_backoff = float(lr_backoff)
        self.max_retries = int(max_retries)
        self.flush_every = max(int(flush_every), 1)
        self.trips = 0
        self.retries = 0
        self._pending: List[Any] = []
        self._warned = False

    def _bad_value(self, v: float) -> bool:
        return (not math.isfinite(v)) or (
            self.spike_limit is not None and v > self.spike_limit)

    def observe(self, model, score) -> None:
        """Feed one step's score (device scalar or float) from the fit loop."""
        if self.policy == "rollback":
            v = float(score)
            if self._bad_value(v):
                self._trip(model, v)
            return
        self._pending.append(score)
        if len(self._pending) >= self.flush_every:
            self.flush(model)

    def flush(self, model) -> None:
        """Read the pending window as ONE stacked copy and act on it."""
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        dev = next((v.device for v in pend if isinstance(v, torch.Tensor)),
                   torch.device("cpu"))
        vals = torch.stack([
            torch.as_tensor(v, dtype=torch.float32, device=dev).detach().reshape(())
            for v in pend]).cpu().numpy()
        bad = ~np.isfinite(vals)
        if self.spike_limit is not None:
            bad |= vals > self.spike_limit
        if bad.any():
            self._trip(model, float(vals[bad][0]))

    def _trip(self, model, value: float) -> None:
        self.trips += 1
        bucketing.telemetry().record_guard(self.policy)
        obs.event("divergence", policy=self.policy, score=repr(value),
                  trips=self.trips)
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"DivergenceGuard: non-finite or spiking training score "
                f"{value!r} (policy={self.policy}, trip #{self.trips})")
        if self.policy != "rollback":
            return
        if self.retries >= self.max_retries:
            raise DivergenceError(
                f"divergence persisted through {self.retries} rollback "
                f"retries (last score {value!r})")
        self.retries += 1
        if resume(model, self.checkpoint_dir) is None:
            raise DivergenceError(
                f"cannot roll back: no valid checkpoint in "
                f"{str(self.checkpoint_dir)!r}")
        # compounding backoff on top of whatever scale the checkpoint carried
        model._lr_scale = getattr(model, "_lr_scale", 1.0) * self.lr_backoff
        model._build_updaters()
        runner = getattr(model, "_dp_runner", None)
        if runner is not None and runner.active:
            runner.reload()   # the exchange's layout around the restored state
        bucketing.telemetry().record_guard("rollback_restore")
        obs.event("rollback_restore", retries=self.retries,
                  lr_scale=float(model._lr_scale))


_INVALID_SCORE_WARNED = False


def note_score(score: float) -> None:
    """InvalidScoreIterationTerminationCondition semantics on the default
    fit path: when the listener score (already read for the listeners) goes
    non-finite, count it in the telemetry and warn once."""
    if math.isfinite(score):
        return
    bucketing.telemetry().record_guard("invalid_score")
    obs.event("invalid_score", score=repr(score))
    global _INVALID_SCORE_WARNED
    if not _INVALID_SCORE_WARNED:
        _INVALID_SCORE_WARNED = True
        warnings.warn(
            f"training score became non-finite ({score!r}). Attach "
            "DivergenceGuard(policy='skip_batch'|'rollback') via "
            "model.set_divergence_guard(...) to recover automatically, or an "
            "early-stopping InvalidScoreIterationTerminationCondition to "
            "terminate")


# ---------------------------------------------------------------------------
# Chaos harness
# ---------------------------------------------------------------------------


class ChaosPreemption(RuntimeError):
    """Raised by the chaos injector to simulate a preemption (the in-process
    flavor of kill; ``preempt@iter:K:kill`` sends a real SIGKILL instead)."""


@dataclass
class _Fault:
    kind: str
    at_iter: Optional[int] = None
    at_ckpt: Optional[int] = None
    arg: Optional[str] = None
    fired: bool = False


_FAULT_KINDS = ("preempt", "corrupt_ckpt", "nan_grad", "slow_iter",
                "host_kill", "net_partition", "slice_kill", "rack_partition")


def _parse_fault(token: str) -> _Fault:
    name, at_iter, at_ckpt, arg = token, None, None, None
    if "@" in token:
        name, rest = token.split("@", 1)
        parts = rest.split(":")
        if len(parts) < 2 or not parts[1]:
            raise ValueError(
                f"chaos fault {token!r}: anchor must be @iter:K or @ckpt:K")
        where, val = parts[0], parts[1]
        arg = ":".join(parts[2:]) or None
        if where == "iter":
            at_iter = int(val)
        elif where == "ckpt":
            at_ckpt = int(val)
        else:
            raise ValueError(
                f"chaos fault {token!r}: unknown anchor @{where} "
                "(use @iter:K or @ckpt:K)")
    elif ":" in token:
        name, arg = token.split(":", 1)
    if name not in _FAULT_KINDS:
        raise ValueError(
            f"chaos fault {token!r}: unknown kind {name!r} "
            f"(known: {', '.join(_FAULT_KINDS)})")
    return _Fault(kind=name, at_iter=at_iter, at_ckpt=at_ckpt, arg=arg)


def _nan_like(x):
    """NaN-poison the float members of a batch (integer token-id features
    cannot hold NaN and pass through untouched)."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(_nan_like(a) for a in x)
    if isinstance(x, torch.Tensor):
        return x * float("nan") if x.is_floating_point() else x
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        return a * a.dtype.type(np.nan)
    return x


def corrupt_file(path, mode: str = "bitflip") -> None:
    """Deterministically damage a file in place: ``truncate`` halves it
    (size mismatch), ``bitflip`` XORs one mid-file byte (CRC mismatch at an
    unchanged size)."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return
    if mode != "bitflip":
        raise ValueError(f"corrupt_ckpt arg {mode!r}: use truncate|bitflip")
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([(b[0] ^ 0x40) if b else 0xFF]))


class ChaosInjector:
    """Deterministic fault injector. Grammar (``DL4J_TPU_CHAOS``):

    comma-separated faults, each ``kind[@iter:K|@ckpt:K][:arg]``:

    - ``preempt@iter:K[:kill]`` — die before the step whose iteration
      counter is >= K runs: raise :class:`ChaosPreemption` (default) or send
      a real SIGKILL (``:kill``). Fires once per process.
    - ``nan_grad[@iter:K]`` — NaN-poison the batch features of iteration K
      (every float activation and gradient downstream goes NaN). Fires once.
    - ``slow_iter[@iter:K][:rankN][:seconds]`` — sleep before the step
      (default 0.05 s); without an anchor, every step (a stalled iterator).
      A ``rankN`` target limits the stall to one data-parallel rank — the
      deterministic straggler the fleet skew detector must flag.
    - ``corrupt_ckpt[@ckpt:K][:truncate|bitflip]`` — damage checkpoint
      number K (or the first one written) AFTER its CRC is recorded, so
      validation must catch it. Fires once.
    - ``host_kill@iter:K[:rankN]`` — SIGKILL the process before the step
      whose iteration is >= K, only when this worker's elastic rank matches
      ``rankN`` (no target: every rank that consults the hook). Fires once;
      drives the elastic shrink path.
    - ``net_partition@iter:K[:rankN][:seconds]`` — this worker lands on the
      wrong side of a switch: the elastic runtime suspends its lease
      heartbeat and stalls for ``seconds`` (default 5.0). A stall longer
      than the lease TTL gets the worker expelled; on waking it renews its
      lease and rejoins through the membership handoff.
    - ``slice_kill@iter:K[:sliceN]`` — SIGKILL the member whose slice index
      (= elastic rank) matches ``sliceN``: one whole-slice preemption, one
      membership event.
    - ``rack_partition@iter:K[:LABEL][:seconds]`` — ``net_partition`` for a
      whole rack: every worker whose ``DL4J_TPU_RACK`` label equals
      ``LABEL`` (no label: all workers) suspends its heartbeat and stalls
      for ``seconds`` (default 5.0).

    Faults are host-side and one-shot: a resumed run that re-executes the
    target iteration is not hit again (``install_chaos(None)`` or clearing
    the variable gives a clean resume).
    """

    def __init__(self, faults, spec: str = ""):
        self.faults = list(faults)
        self.spec = spec

    @staticmethod
    def parse(spec: str) -> "ChaosInjector":
        faults = [_parse_fault(t.strip()) for t in spec.split(",") if t.strip()]
        return ChaosInjector(faults, spec)

    # -- per-iteration hooks (fit dispatch paths) ---------------------------
    def maybe_preempt(self, iteration: int) -> None:
        for f in self.faults:
            if (f.kind == "preempt" and not f.fired
                    and f.at_iter is not None and iteration >= f.at_iter):
                f.fired = True
                obs.event("chaos", fault="preempt", iteration=iteration,
                          arg=f.arg)
                if f.arg == "kill":
                    os.kill(os.getpid(), signal.SIGKILL)
                raise ChaosPreemption(
                    f"chaos: preempted at iteration {iteration}")

    def maybe_slow(self, iteration: int, *, rank: Optional[int] = None) -> None:
        for f in self.faults:
            if f.kind != "slow_iter":
                continue
            # rank-targeted straggler injection (``slow_iter:rank1:0.5``):
            # only the targeted data-parallel rank stalls
            target, rest = self._rank_arg(f.arg)
            if target is not None and (rank is None or rank != target):
                continue
            if f.at_iter is None or (iteration == f.at_iter and not f.fired):
                if f.at_iter is not None:
                    f.fired = True
                    obs.event("chaos", fault="slow_iter", iteration=iteration,
                              rank=rank)
                time.sleep(float(rest) if rest else 0.05)

    def maybe_nan_batch(self, iteration: int, x):
        for f in self.faults:
            if f.kind != "nan_grad" or f.fired:
                continue
            if f.at_iter is None or iteration == f.at_iter:
                f.fired = True
                obs.event("chaos", fault="nan_grad", iteration=iteration)
                return _nan_like(x)
        return x

    # -- distributed hooks (ElasticTrainer step boundary) -------------------
    @staticmethod
    def _prefixed_arg(arg: Optional[str], prefix: str):
        """Split a fault arg into (target_index, rest) for a ``<prefix>N``
        head: ``rank1:4.0`` -> (1, "4.0"), ``slice2`` -> (2, None), a
        non-matching head -> (None, arg)."""
        if not arg:
            return None, None
        head, _, rest = arg.partition(":")
        if head.startswith(prefix) and head[len(prefix):].isdigit():
            return int(head[len(prefix):]), (rest or None)
        return None, arg

    @staticmethod
    def _rank_arg(arg: Optional[str]):
        """Split a fault arg into (target_rank, rest): ``rank1:4.0`` ->
        (1, "4.0"), ``rank2`` -> (2, None), ``3.5`` -> (None, "3.5")."""
        return ChaosInjector._prefixed_arg(arg, "rank")

    def maybe_host_kill(self, iteration: int, *, rank: int) -> None:
        for f in self.faults:
            if (f.kind != "host_kill" or f.fired or f.at_iter is None
                    or iteration < f.at_iter):
                continue
            target, _ = self._rank_arg(f.arg)
            if target is not None and target != rank:
                continue
            f.fired = True
            obs.event("chaos", fault="host_kill", iteration=iteration, rank=rank)
            os.kill(os.getpid(), signal.SIGKILL)

    def maybe_slice_kill(self, iteration: int, *, slice_index: int,
                         process_group: bool = False) -> None:
        """SIGKILL this member when a ``slice_kill`` fault targets its slice
        index — one whole-slice preemption, one membership event. With
        ``process_group`` (the leader of a member of several rank processes,
        which the elastic launcher starts in a process group of its own) the
        whole process group goes, every rank of the member; else this
        process."""
        for f in self.faults:
            if (f.kind != "slice_kill" or f.fired or f.at_iter is None
                    or iteration < f.at_iter):
                continue
            target, _ = self._prefixed_arg(f.arg, "slice")
            if target is not None and target != slice_index:
                continue
            f.fired = True
            obs.event("slice_kill", iteration=iteration, slice=slice_index)
            obs.event("chaos", fault="slice_kill", iteration=iteration,
                      slice=slice_index)
            if process_group:
                os.killpg(os.getpgrp(), signal.SIGKILL)
            os.kill(os.getpid(), signal.SIGKILL)

    def rack_partition_seconds(self, iteration: int, *, rack: str) -> float:
        """Non-zero when a ``rack_partition`` fault hits this worker's rack
        label at this iteration; the caller owns the mechanics (suspend
        heartbeat + stall), same as :meth:`partition_seconds`."""
        for f in self.faults:
            if (f.kind != "rack_partition" or f.fired or f.at_iter is None
                    or iteration < f.at_iter):
                continue
            label: Optional[str] = None
            secs = 5.0
            if f.arg:
                head, _, rest = f.arg.partition(":")
                try:
                    secs = float(head)   # bare seconds: every rack
                except ValueError:
                    label = head
                    if rest:
                        secs = float(rest)
            if label is not None and label != rack:
                continue
            f.fired = True
            obs.event("chaos", fault="rack_partition", iteration=iteration,
                      rack=rack, seconds=secs)
            return secs
        return 0.0

    def partition_seconds(self, iteration: int, *, rank: int) -> float:
        """Non-zero when a ``net_partition`` fault targets this (iteration,
        rank); the caller owns the mechanics (suspend heartbeat + stall)."""
        for f in self.faults:
            if (f.kind != "net_partition" or f.fired or f.at_iter is None
                    or iteration < f.at_iter):
                continue
            target, rest = self._rank_arg(f.arg)
            if target is not None and target != rank:
                continue
            f.fired = True
            obs.event("chaos", fault="net_partition", iteration=iteration,
                      rank=rank, seconds=rest)
            return float(rest) if rest else 5.0
        return 0.0

    # -- checkpoint hook (CheckpointListener._save) -------------------------
    def maybe_corrupt(self, path, ckpt_number: int) -> None:
        for f in self.faults:
            if f.kind != "corrupt_ckpt" or f.fired:
                continue
            if f.at_ckpt is None or ckpt_number == f.at_ckpt:
                f.fired = True
                obs.event("chaos", fault="corrupt_ckpt", path=str(path),
                          mode=f.arg or "bitflip")
                corrupt_file(path, mode=f.arg or "bitflip")


_UNSET = object()
_chaos_override: Any = _UNSET
_env_injectors: Dict[str, ChaosInjector] = {}


def install_chaos(spec):
    """Programmatic chaos install (wins over ``DL4J_TPU_CHAOS``). Pass a
    grammar string or a :class:`ChaosInjector`; ``None`` clears the override
    (the environment variable rules again). Returns the active injector."""
    global _chaos_override
    if spec is None:
        _chaos_override = _UNSET
        return None
    inj = spec if isinstance(spec, ChaosInjector) else ChaosInjector.parse(spec)
    _chaos_override = inj
    return inj


def active_chaos() -> Optional[ChaosInjector]:
    """The installed injector, the env-configured one, or None. The env
    injector is cached per spec string so one-shot faults stay one-shot
    across the many hooks that consult it."""
    if _chaos_override is not _UNSET:
        return _chaos_override
    spec = os.environ.get("DL4J_TPU_CHAOS")
    if not spec:
        return None
    inj = _env_injectors.get(spec)
    if inj is None:
        inj = ChaosInjector.parse(spec)
        _env_injectors[spec] = inj
    return inj
