"""Training listeners: the hook SPI of the reference (a copy of the host-only
``deeplearning4j_tpu/train/listeners.py``).

Parity: optimize/api/TrainingListener.java + the implementations under
optimize/listeners/ (ScoreIterationListener, PerformanceListener,
CollectScoresIterationListener, TimeIterationListener,
EvaluativeListener), and ProfilerListener, a ``torch.profiler`` window. A
listener fires on the host after each step with the step's loss as a
Python float (``fit`` reads the loss from the device only when a listener
is attached).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = [
    "BaseTrainingListener",
    "CollectScoresListener",
    "ComposedListener",
    "EvaluativeListener",
    "PerformanceListener",
    "ProfilerListener",
    "ScoreIterationListener",
    "TimeIterationListener",
    "TrainingListener",
    "close_listeners",
]


class TrainingListener:
    """Hook interface. All methods are optional no-ops."""

    def on_epoch_start(self, model, epoch: int):  # noqa: D102
        pass

    def on_epoch_end(self, model, epoch: int):  # noqa: D102
        pass

    def iteration_done(self, model, iteration: int, score: float, batch_size: int = 0):
        pass

    def on_gradient_calculation(self, model, iteration: int):
        pass


BaseTrainingListener = TrainingListener


class ScoreIterationListener(TrainingListener):
    """Log the score every N iterations (ScoreIterationListener.java)."""

    def __init__(self, print_every: int = 10, out: Optional[Callable[[str], None]] = None):
        self.print_every = max(1, print_every)
        self.out = out or (lambda s: logger.info(s))

    def iteration_done(self, model, iteration, score, batch_size=0):
        if iteration % self.print_every == 0:
            self.out(f"Score at iteration {iteration} is {score}")


class PerformanceListener(TrainingListener):
    """Throughput reporting: samples/sec, batches/sec
    (PerformanceListener.java). Host clock between listener calls."""

    def __init__(self, frequency: int = 10, out: Optional[Callable[[str], None]] = None):
        self.frequency = max(1, frequency)
        self.out = out or (lambda s: logger.info(s))
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self._samples = 0
        self.history: List[dict] = []

    def iteration_done(self, model, iteration, score, batch_size=0):
        now = time.perf_counter()
        # anchor before accumulating, so the anchoring call's batch counts
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
        self._samples += batch_size
        if iteration - self._last_iter >= self.frequency:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            rec = {
                "iteration": iteration,
                "batches_per_sec": iters / dt if dt > 0 else float("inf"),
                "samples_per_sec": self._samples / dt if dt > 0 else float("inf"),
                "score": score,
            }
            self.history.append(rec)
            self.out(
                f"iteration {iteration}: {rec['samples_per_sec']:.1f} samples/sec, "
                f"{rec['batches_per_sec']:.2f} batches/sec, score {score}"
            )
            self._last_time = now
            self._last_iter = iteration
            self._samples = 0


class ProfilerListener(TrainingListener):
    """Profile a window of training iterations with ``torch.profiler`` (CPU
    activities, and CUDA kernels when a card is present) and write a Chrome
    trace (``trace.json``, chrome://tracing or Perfetto) to ``log_dir``::

        model.set_listeners(ProfilerListener("/tmp/trace", start=10, stop=20))

    The window opens at the first iteration >= ``start`` and closes at the
    first >= ``stop``; ``profile`` holds the profiler afterwards
    (``key_averages()``), ``trace_path`` the file."""

    def __init__(self, log_dir: str, start: int = 10, stop: int = 20):
        if stop <= start:
            raise ValueError("stop must be > start")
        self.log_dir = str(log_dir)
        self.start = start
        self.stop = stop
        self._active = False
        self.captured = False
        self.profile = None
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration, score, batch_size=0):
        if not self._active and not self.captured and iteration >= self.start:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=acts)
            self.profile.__enter__()
            self._active = True
        elif self._active and iteration >= self.stop:
            self._finish()

    def _finish(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.__exit__(None, None, None)
        self._active = False
        self.captured = True
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir, "trace.json")
        self.profile.export_chrome_trace(self.trace_path)

    def close(self):
        """Stop an open window (training ended inside it). Epoch ends do not
        stop it: a window may span epochs."""
        if self._active:
            self._finish()


class CollectScoresListener(TrainingListener):
    """Accumulate (iteration, score) pairs
    (CollectScoresIterationListener.java)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, score, batch_size=0):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class TimeIterationListener(TrainingListener):
    """ETA logging over a known iteration budget (TimeIterationListener.java)."""

    def __init__(self, total_iterations: int, frequency: int = 100,
                 out: Optional[Callable[[str], None]] = None):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self.out = out or (lambda s: logger.info(s))
        self.start = time.perf_counter()

    def iteration_done(self, model, iteration, score, batch_size=0):
        if iteration and iteration % self.frequency == 0:
            elapsed = time.perf_counter() - self.start
            rate = iteration / elapsed
            remaining = (self.total - iteration) / rate if rate > 0 else float("inf")
            self.out(f"iteration {iteration}/{self.total}, ETA {remaining:.0f}s")


class EvaluativeListener(TrainingListener):
    """Periodically evaluate on a held-out set (EvaluativeListener.java)."""

    def __init__(self, data, frequency_epochs: int = 1,
                 out: Optional[Callable[[str], None]] = None):
        self.data = data
        self.frequency_epochs = max(1, frequency_epochs)
        self.out = out or (lambda s: logger.info(s))
        self.evaluations: List[object] = []

    def on_epoch_end(self, model, epoch):
        if epoch % self.frequency_epochs == 0:
            ev = model.evaluate(self.data)
            self.evaluations.append(ev)
            self.out(f"epoch {epoch}: accuracy {ev.accuracy():.4f} f1 {ev.f1():.4f}")


class ComposedListener(TrainingListener):
    """Fan out to several listeners."""

    def __init__(self, listeners: List[TrainingListener]):
        self.listeners = list(listeners)

    def on_epoch_start(self, model, epoch):
        for l in self.listeners:
            l.on_epoch_start(model, epoch)

    def on_epoch_end(self, model, epoch):
        for l in self.listeners:
            l.on_epoch_end(model, epoch)

    def iteration_done(self, model, iteration, score, batch_size=0):
        for l in self.listeners:
            l.iteration_done(model, iteration, score, batch_size)

    def on_gradient_calculation(self, model, iteration):
        for l in self.listeners:
            l.on_gradient_calculation(model, iteration)

    def close(self):
        close_listeners(self.listeners)


def close_listeners(listeners) -> None:
    """Call ``close()`` on every listener that defines one (fit teardown).
    Errors are logged, not raised: teardown must not mask the fit's own
    outcome."""
    for l in listeners or ():
        close = getattr(l, "close", None)
        if callable(close):
            try:
                close()
            except Exception:
                logger.exception("listener %r close() failed", type(l).__name__)
