"""Periodic checkpointing listener with retention policies (PyTorch port
of ``deeplearning4j_tpu/train/checkpoint.py``).

Parity: optimize/listeners/checkpoint/CheckpointListener.java:72
(saveEveryNEpochs:83, saveEveryNIterations, saveEvery(time), keepAll,
keepLast:79, keepLastAndEvery:37-65) plus the static restore helpers
(loadCheckpoint, lastCheckpoint).

Durability (train/resilience.py): saves route through
``resilience.save_checkpoint`` — atomic zip write + full train state (the
model generator's state, batch position, LR scale) — and each index entry records
the file's CRC32 + size so ``last_valid_checkpoint`` can skip corrupt or
truncated files when resuming. Time-based saves use ``time.monotonic()``
(wall-clock steps must not suppress or duplicate saves).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import List, Optional

from deeplearning4j_tpu_torch.train.listeners import TrainingListener


@dataclass
class Checkpoint:
    number: int
    iteration: int
    epoch: int
    timestamp: float
    filename: str
    crc: Optional[int] = None
    size: Optional[int] = None


class CheckpointListener(TrainingListener):
    """Save the model every N epochs / iterations / seconds; retention via
    keep_all / keep_last=k / keep_last_and_every=(k, n)."""

    INDEX = "checkpointInfo.json"

    def __init__(
        self,
        directory,
        save_every_n_epochs: Optional[int] = None,
        save_every_n_iterations: Optional[int] = None,
        save_every_seconds: Optional[float] = None,
        keep_all: bool = False,
        keep_last: Optional[int] = None,
        keep_last_and_every: Optional[tuple] = None,
        delete_existing: bool = False,
    ):
        if not (save_every_n_epochs or save_every_n_iterations or save_every_seconds):
            raise ValueError("Set one of save_every_n_epochs/_iterations/_seconds")
        if not keep_all and keep_last is None and keep_last_and_every is None:
            keep_last = 3
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        if delete_existing:
            for c in self.checkpoints(self.directory):
                try:
                    os.remove(os.path.join(self.directory, c.filename))
                except OSError:
                    pass
            idx = os.path.join(self.directory, self.INDEX)
            if os.path.exists(idx):
                os.remove(idx)
        self.save_every_n_epochs = save_every_n_epochs
        self.save_every_n_iterations = save_every_n_iterations
        self.save_every_seconds = save_every_seconds
        self.keep_all = keep_all
        self.keep_last = keep_last
        self.keep_last_and_every = keep_last_and_every
        self._last_save_time = time.monotonic()
        self._count = self._load_count()
        # what each save of this listener wrote: path, crc, size, seconds
        self.saves: List[dict] = []

    # -- listener hooks ----------------------------------------------------
    def iteration_done(self, model, iteration, score, batch_size=0):
        if (
            self.save_every_n_iterations
            and iteration > 0
            and iteration % self.save_every_n_iterations == 0
        ):
            self._save(model)
        elif self.save_every_seconds and (
            time.monotonic() - self._last_save_time >= self.save_every_seconds
        ):
            self._save(model)

    def on_epoch_end(self, model, epoch):
        if self.save_every_n_epochs and (epoch + 1) % self.save_every_n_epochs == 0:
            self._save(model)

    # -- mechanics ---------------------------------------------------------
    def _index_path(self):
        return os.path.join(self.directory, self.INDEX)

    def _load_count(self) -> int:
        if os.path.exists(self._index_path()):
            with open(self._index_path()) as f:
                entries = json.load(f)
            return (max(e["number"] for e in entries) + 1) if entries else 0
        return 0

    def _load_index(self) -> List[dict]:
        if os.path.exists(self._index_path()):
            with open(self._index_path()) as f:
                return json.load(f)
        return []

    def _save(self, model):
        from deeplearning4j_tpu_torch.train import resilience

        num = self._count
        self._count += 1
        fname = f"checkpoint_{num}_iter_{model.iteration}_epoch_{model.epoch}.zip"
        path = os.path.join(self.directory, fname)
        info = resilience.save_checkpoint(model, path)
        self.saves.append(info)
        entries = self._load_index()
        entries.append(
            {
                "number": num,
                "iteration": model.iteration,
                "epoch": model.epoch,
                "timestamp": time.time(),
                "filename": fname,
                "crc": info["crc"],
                "size": info["size"],
            }
        )
        self._write_index(entries)
        self._last_save_time = time.monotonic()
        # chaos corruption lands AFTER the CRC is recorded: validation, not
        # the write path, must be what catches the damaged file
        chaos = resilience.active_chaos()
        if chaos is not None:
            chaos.maybe_corrupt(path, num)
        self._apply_retention(entries)

    def _apply_retention(self, entries: List[dict]):
        if self.keep_all:
            return
        keep = set()
        if self.keep_last is not None:
            for e in entries[-self.keep_last :]:
                keep.add(e["number"])
        if self.keep_last_and_every is not None:
            k, every = self.keep_last_and_every
            for e in entries[-k:]:
                keep.add(e["number"])
            for e in entries:
                if e["number"] % every == 0:
                    keep.add(e["number"])
        remaining = []
        for e in entries:
            if e["number"] in keep:
                remaining.append(e)
            else:
                try:
                    os.remove(os.path.join(self.directory, e["filename"]))
                except OSError:
                    pass
        self._write_index(remaining)

    def _write_index(self, entries: List[dict]) -> None:
        """ATOMIC index write (temp + fsync + os.replace): a process killed
        mid-save — or a concurrent reader polling for resume — must never
        observe a truncated checkpointInfo.json (the preemption-recovery
        contract)."""
        tmp = self._index_path() + f".{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(entries, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._index_path())

    # -- static inspection/restore helpers ---------------------------------
    @staticmethod
    def checkpoints(directory) -> List[Checkpoint]:
        idx = os.path.join(str(directory), CheckpointListener.INDEX)
        if not os.path.exists(idx):
            return []
        with open(idx) as f:
            return [Checkpoint(e["number"], e["iteration"], e["epoch"],
                               e["timestamp"], e["filename"],
                               e.get("crc"), e.get("size"))
                    for e in json.load(f)]

    @staticmethod
    def last_checkpoint(directory) -> Optional[Checkpoint]:
        cps = CheckpointListener.checkpoints(directory)
        return cps[-1] if cps else None

    @staticmethod
    def last_valid_checkpoint(directory) -> Optional[Checkpoint]:
        """Newest checkpoint whose file passes CRC/size (or structural)
        validation — corrupt or truncated files fall through to older ones."""
        from deeplearning4j_tpu_torch import obs
        from deeplearning4j_tpu_torch.train import resilience

        for c in reversed(CheckpointListener.checkpoints(directory)):
            path = os.path.join(str(directory), c.filename)
            if resilience.validate_checkpoint(path, crc=c.crc, size=c.size):
                return c
            obs.event("checkpoint_corrupt_fallback", path=path,
                      number=c.number)
        return None

    @staticmethod
    def load_checkpoint(directory, number: int, device=None):
        """Checkpoint ``number`` restored as a model on ``device`` (the GPU
        unless named)."""
        from deeplearning4j_tpu_torch.utils.serialization import restore_network

        for c in CheckpointListener.checkpoints(directory):
            if c.number == number:
                return restore_network(os.path.join(str(directory), c.filename),
                                       device=device)
        raise FileNotFoundError(f"No checkpoint #{number} in {directory}")

    @staticmethod
    def load_last_checkpoint(directory, device=None):
        c = CheckpointListener.last_checkpoint(directory)
        if c is None:
            raise FileNotFoundError(f"No checkpoints in {directory}")
        from deeplearning4j_tpu_torch.utils.serialization import restore_network

        return restore_network(os.path.join(str(directory), c.filename), device=device)

    @staticmethod
    def load_last_valid_checkpoint(directory, device=None):
        c = CheckpointListener.last_valid_checkpoint(directory)
        if c is None:
            raise FileNotFoundError(f"No valid checkpoints in {directory}")
        from deeplearning4j_tpu_torch.utils.serialization import restore_network

        return restore_network(os.path.join(str(directory), c.filename), device=device)
