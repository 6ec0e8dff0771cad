"""Distributed Word2Vec over ``torch.distributed`` ranks (the port of the
JAX package's ``nlp/distributed.py``).

Capability parity with the reference's Spark NLP scaleout
(deeplearning4j-scaleout/spark/dl4j-spark-nlp: SparkWord2Vec — distributed
vocabulary construction on the Spark master + parameter-averaged training
rounds). No rank is a master: every rank holds a corpus shard, in the
default process group that ``parallel/distributed.py`` ``init_distributed``
formed (NCCL on cards, gloo on the CPU):

1. **Distributed vocab build**: local token counts are exchanged with
   ``all_gather_object`` and merged identically on every rank — all ranks
   end with the SAME vocab (word order included), the JAX package's.
2. **Parameter-averaged rounds**: each round runs local epochs with the
   negative-sampling steps (nlp/embeddings.py), then every table is
   all-reduced and divided by the world size (the Spark master's averaging
   step, exact).

Without a process group fit is plain Word2Vec.fit, so the same code
serves both paths; in a group of one the collectives run and change
nothing.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import torch.distributed as dist

from deeplearning4j_tpu_torch.nlp.embeddings import Word2Vec
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord, build_huffman


def _group_size() -> int:
    """Ranks in the default process group; 0 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def _allgather_objects(obj) -> List[dict]:
    """Exchange one picklable object per rank; returns every rank's object
    (rank order, the same everywhere). Without a process group: [obj]."""
    n = _group_size()
    if n == 0:
        return [obj]
    out: List = [None] * n
    dist.all_gather_object(out, obj)
    return out


class DistributedWord2Vec(Word2Vec):
    """Word2Vec whose fit() spans every rank of the default process group.

    ``rounds``: parameter-averaging rounds; each runs ``epochs_per_round``
    local epochs (total work ≈ rounds * epochs_per_round per shard). The
    model's ``device`` must be the one the group runs on (a card for
    NCCL, ``"cpu"`` for gloo).
    """

    def __init__(self, rounds: int = 1, epochs_per_round: int = 1, **kw):
        if "epochs" in kw:
            raise ValueError(
                "DistributedWord2Vec: pass rounds=/epochs_per_round= instead "
                "of epochs= (total epochs = rounds * epochs_per_round)")
        kw["epochs"] = rounds * epochs_per_round
        super().__init__(**kw)
        self.rounds = rounds
        self.epochs_per_round = epochs_per_round

    # -- distributed vocab -------------------------------------------------
    def build_vocab_distributed(self, local_token_seqs: Sequence[Sequence[str]]):
        counts: Counter = Counter()
        total = 0
        for toks in local_token_seqs:
            counts.update(toks)
            total += len(toks)
        merged: Counter = Counter()
        g_total = 0
        for remote in _allgather_objects(
                {"counts": dict(counts), "total": total}):
            merged.update(remote["counts"])
            g_total += remote["total"]
        cache = VocabCache()
        for w, c in sorted(merged.items(), key=lambda kv: (-kv[1], kv[0])):
            if c >= self.min_word_frequency:
                cache.add(VocabWord(w, c))
        cache.total_word_count = g_total
        self.vocab = cache
        if self.use_hs:
            build_huffman(self.vocab)
        return self

    # -- parameter averaging ----------------------------------------------
    def _average_params(self):
        n = _group_size()
        if n == 0:
            return
        for v in self.params.values():
            dist.all_reduce(v, op=dist.ReduceOp.SUM)
            v.div_(n)

    # -- training ----------------------------------------------------------
    def fit(self, local_sentences) -> "DistributedWord2Vec":
        """``local_sentences``: THIS rank's shard of the corpus."""
        seqs = local_sentences() if callable(local_sentences) else local_sentences
        token_seqs = self._tokenize_all(seqs)
        if self.vocab is None:
            self.build_vocab_distributed(token_seqs)
        if self.params is None:
            self._init_params()   # same seed everywhere -> identical init
        idx_seqs = self._index_sequences(token_seqs)
        span = self.rounds * self.epochs_per_round
        for r in range(self.rounds):
            # the lr anneals ONCE across all rounds (not per round)
            self._run_epochs(idx_seqs, self.epochs_per_round,
                             schedule_span=span,
                             schedule_offset=r * self.epochs_per_round)
            self._average_params()
        return self
