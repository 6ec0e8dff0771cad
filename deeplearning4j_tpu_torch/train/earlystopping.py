"""Early stopping: epoch/iteration termination + best-model saving
(PyTorch port of ``deeplearning4j_tpu/train/earlystopping.py``).

Parity: earlystopping/ in the reference — EarlyStoppingConfiguration,
trainer/BaseEarlyStoppingTrainer.java:52-113 (the epoch loop with
IterationTerminationCondition / EpochTerminationCondition checks),
termination/ (MaxEpochs, ScoreImprovementEpoch, BestScoreEpoch,
MaxTimeIteration, MaxScoreIteration, InvalidScoreIteration),
saver/ (LocalFileModelSaver, InMemoryModelSaver), scorecalc/
(DataSetLossCalculator).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch


# ---------------------------------------------------------------------------
# Termination conditions
# ---------------------------------------------------------------------------


class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after ``patience`` epochs without ≥ min_improvement improvement."""

    def __init__(self, patience: int, min_improvement: float = 0.0):
        self.patience = patience
        self.min_improvement = min_improvement

    def initialize(self):
        self.best = math.inf
        self.best_epoch = -1

    def terminate(self, epoch, score):
        if score < self.best - self.min_improvement:
            self.best = score
            self.best_epoch = epoch
            return False
        return epoch - self.best_epoch >= self.patience

    def __str__(self):
        return (
            f"ScoreImprovementEpochTerminationCondition(patience={self.patience}, "
            f"minImprovement={self.min_improvement})"
        )


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score reaches a target value."""

    def __init__(self, best_expected: float):
        self.best_expected = best_expected

    def terminate(self, epoch, score):
        return score <= self.best_expected

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds

    def initialize(self):
        # monotonic: an NTP step must not shorten (or extend) the budget
        self._t0 = time.monotonic()

    def terminate(self, last_score):
        return time.monotonic() - self._t0 >= self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Divergence protection: stop if score explodes past a bound."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop on NaN/Inf score."""

    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"


class MaxParamNormIterationTerminationCondition(IterationTerminationCondition):
    """Divergence protection on the PARAMETERS, not the score: stop once the
    global L2 norm of the model's parameters exceeds ``max_norm`` (or goes
    non-finite). A stable log-softmax loss cannot overflow, and a huge
    divergent step can even land a toy model on a perfect separator with
    score exactly 0.0 — the parameter norm is the signal that still
    explodes when the score cannot (the JAX package's test notes).

    ``needs_model = True``: the iteration guard passes the live model so the
    norm is read from ``model.params``. One scalar host sync per iteration,
    on the early-stopping path only — never inside a traced step."""

    needs_model = True

    def __init__(self, max_norm: float):
        if not max_norm > 0:
            raise ValueError(f"max_norm must be positive, got {max_norm}")
        self.max_norm = max_norm

    def terminate(self, last_score, model=None):
        if model is None or getattr(model, "params", None) is None:
            return False
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves

        sq = 0.0
        for leaf in tree_leaves(model.params):
            sq += float(torch.sum(torch.square(leaf.detach().float())))
        norm = math.sqrt(sq) if math.isfinite(sq) else math.inf
        return norm > self.max_norm or not math.isfinite(norm)

    def __str__(self):
        return f"MaxParamNormIterationTerminationCondition({self.max_norm})"


# ---------------------------------------------------------------------------
# Score calculators
# ---------------------------------------------------------------------------


class ScoreCalculator:
    def calculate_score(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out set (scorecalc/DataSetLossCalculator)."""

    def __init__(self, data, batch_size: Optional[int] = None):
        self.data = data
        self.batch_size = batch_size

    def calculate_score(self, model) -> float:
        from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork, _iter_batches

        if isinstance(model, MultiLayerNetwork):
            total, n = 0.0, 0
            source = self.data() if callable(self.data) else self.data
            for x, y, fm, lm in _iter_batches(source, self.batch_size):
                b = len(x)
                total += model.score(x, y, fmask=fm, lmask=lm) * b
                n += b
            return total / max(n, 1)
        # ComputationGraph
        total, n = 0.0, 0
        source = self.data() if callable(self.data) else self.data
        for batch in model._iter_multi(source, self.batch_size):
            f = batch[0]
            b = f[0].shape[0]
            total += model.score(batch) * b
            n += b
        return total / max(n, 1)


class ClassificationScoreCalculator(ScoreCalculator):
    """negated accuracy/f1 so 'lower is better' holds
    (scorecalc/ClassificationScoreCalculator)."""

    def __init__(self, data, metric: str = "accuracy", batch_size: Optional[int] = None):
        self.data = data
        self.metric = metric
        self.batch_size = batch_size

    def calculate_score(self, model) -> float:
        ev = model.evaluate(self.data, batch_size=self.batch_size)
        return -float(getattr(ev, self.metric)())


# ---------------------------------------------------------------------------
# Model savers
# ---------------------------------------------------------------------------


class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score):
        self._best = model.clone()

    def save_latest_model(self, model, score):
        self._latest = model.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """Zip checkpoints in a directory (saver/LocalFileModelSaver.java)."""

    BEST = "bestModel.zip"
    LATEST = "latestModel.zip"

    def __init__(self, directory, device=None):
        self.directory = str(directory)
        self.device = device   # where get_*_model restores (the GPU unless named)
        os.makedirs(self.directory, exist_ok=True)

    def save_best_model(self, model, score):
        from deeplearning4j_tpu_torch.utils.serialization import save_network

        save_network(model, os.path.join(self.directory, self.BEST))

    def save_latest_model(self, model, score):
        from deeplearning4j_tpu_torch.utils.serialization import save_network

        save_network(model, os.path.join(self.directory, self.LATEST))

    def get_best_model(self):
        from deeplearning4j_tpu_torch.utils.serialization import restore_network

        p = os.path.join(self.directory, self.BEST)
        return restore_network(p, device=self.device) if os.path.exists(p) else None

    def get_latest_model(self):
        from deeplearning4j_tpu_torch.utils.serialization import restore_network

        p = os.path.join(self.directory, self.LATEST)
        return restore_network(p, device=self.device) if os.path.exists(p) else None


# ---------------------------------------------------------------------------
# Configuration / result / trainer
# ---------------------------------------------------------------------------


@dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[EpochTerminationCondition] = field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(
        default_factory=list
    )
    score_calculator: Optional[ScoreCalculator] = None
    model_saver: Any = None
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    termination_reason: str          # "EpochTerminationCondition" | "IterationTerminationCondition" | "Error"
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


class EarlyStoppingTrainer:
    """Drives fit-epoch/evaluate/terminate (BaseEarlyStoppingTrainer:52-113).
    Works for MultiLayerNetwork and ComputationGraph."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_data,
                 batch_size: Optional[int] = None):
        self.config = config
        self.model = model
        self.train_data = train_data
        self.batch_size = batch_size
        if config.model_saver is None:
            config.model_saver = InMemoryModelSaver()

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        model = self.model
        if model.params is None:
            model.init()
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()

        score_vs_epoch = {}
        best_score = math.inf
        best_epoch = -1
        epoch = 0
        reason, details = "EpochTerminationCondition", ""

        class _IterGuard:
            """Listener that raises to abort mid-epoch on iteration
            termination (the reference checks inside the minibatch loop)."""

            class Stop(Exception):
                def __init__(self, cond):
                    self.cond = cond

            def __init__(self, conds):
                self.conds = conds

            def on_epoch_start(self, model, epoch):
                pass

            def on_epoch_end(self, model, epoch):
                pass

            def iteration_done(self, m, it, score, bs=0):
                for c in self.conds:
                    # conditions that inspect model state (param norm)
                    # declare needs_model; score-only conditions keep the
                    # reference signature
                    if getattr(c, "needs_model", False):
                        hit = c.terminate(score, model=m)
                    else:
                        hit = c.terminate(score)
                    if hit:
                        raise _IterGuard.Stop(c)

        guard = _IterGuard(cfg.iteration_termination_conditions)
        saved_listeners = list(model.listeners)
        if cfg.iteration_termination_conditions:
            model.listeners = saved_listeners + [guard]
        try:
            while True:
                try:
                    model.fit(self.train_data, epochs=1, batch_size=self.batch_size)
                except _IterGuard.Stop as s:
                    reason = "IterationTerminationCondition"
                    details = str(s.cond)
                    break

                if cfg.score_calculator is not None and (
                    epoch % max(cfg.evaluate_every_n_epochs, 1) == 0
                ):
                    score = cfg.score_calculator.calculate_score(model)
                else:
                    score = score_vs_epoch.get(epoch - 1, math.inf)
                score_vs_epoch[epoch] = score

                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    cfg.model_saver.save_best_model(model, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(model, score)

                stop = False
                for c in cfg.epoch_termination_conditions:
                    if c.terminate(epoch, score):
                        reason = "EpochTerminationCondition"
                        details = str(c)
                        stop = True
                        break
                epoch += 1
                if stop:
                    break
        finally:
            model.listeners = saved_listeners

        best_model = cfg.model_saver.get_best_model()
        if best_model is None:
            if score_vs_epoch:
                # no saver capture but epochs were scored: current model stands
                best_model = model
                best_epoch = epoch - 1
                best_score = score_vs_epoch.get(epoch - 1, math.inf)
            else:
                # terminated before ANY epoch completed (e.g. divergence mid
                # epoch 0): there is no best model — do not present the
                # possibly-NaN current weights as one
                best_model = None
                best_epoch = -1
                best_score = math.inf
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            score_vs_epoch=score_vs_epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            total_epochs=epoch,
            best_model=best_model,
        )


EarlyStoppingGraphTrainer = EarlyStoppingTrainer
