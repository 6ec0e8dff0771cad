"""The port's DistributedWord2Vec (``nlp/distributed.py``) on the CPU.

Two gloo ranks (subprocesses running ``WORKER``, ``torch.set_num_threads(1)``,
rendezvous through a FileStore under pytest's tmp dir so test workers never
share a port, joined under ``RANK_TIMEOUT_S``) each train on their own
corpus shard: 2 parameter-averaging rounds of 1 epoch. The result is held
against the JAX package's computed in this process from the same shards:
its vocabulary merge (``build_vocab_distributed`` over both shards' counts),
then per round JAX ``Word2Vec._run_epochs`` on each shard and the mean of
the two tables, as its ``_average_params`` takes it. Both ranks must end
with the JAX vocabulary in its order and with tables bit-equal to each
other and within ``FIT_TOL`` of JAX's (f32, summed in other orders by XLA
and PyTorch).
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.nlp.distributed as JD
from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
from deeplearning4j_tpu_torch.nlp.embeddings import Word2Vec

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 120
FIT_TOL = dict(rtol=1e-5, atol=1e-6)
CONF = dict(layer_size=12, min_word_frequency=1, negative=4, seed=9, learning_rate=0.05,
            window=3, batch_size=32)
ROUNDS = 2
SHARDS = [
    ["cat kitten purr feline meow whiskers the"] * 30 + ["the cat sat"] * 5,
    ["dog puppy bark canine woof fetch the"] * 20 + ["a dog ran the"] * 8,
]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # another test module may leave tuning knobs (DL4J_TPU_GRAD_ACCUM, ...)
    # in os.environ; both packages' fit paths read them
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


WORKER = r'''
import pickle, sys
import torch

torch.set_num_threads(1)
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from deeplearning4j_tpu_torch.interop import embeddings_to_numpy
from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
from deeplearning4j_tpu_torch.parallel import init_distributed, shutdown_distributed

init_distributed(f"file://{root}/store", world, rank, device="cpu", timeout_s=90)
with open(f"{root}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
m = DistributedWord2Vec(rounds=inp["rounds"], epochs_per_round=1, device="cpu", **inp["conf"])
m.fit(inp["shards"][rank])
with open(f"{root}/rank{rank}.pkl", "wb") as f:
    pickle.dump({"vocab": [(w.word, w.count) for w in m.vocab.words],
                 "total": m.vocab.total_word_count,
                 "params": embeddings_to_numpy(m)}, f)
shutdown_distributed()
'''


def _spawn_ranks(root: Path, world: int):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    for r in range(world):
        log = open(root / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), str(root)],
            cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        for p, _ in procs:
            p.wait()
        pytest.fail(f"gloo ranks did not finish within {RANK_TIMEOUT_S} s: "
                    + (root / "rank0.log").read_text()[-2000:])
    finally:
        for _, log in procs:
            log.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            pytest.fail(f"rank {r} exited {p.returncode}:\n"
                        + (root / f"rank{r}.log").read_text()[-4000:])


def _jax_two_rounds(monkeypatch):
    """The JAX package's result for the two shards, in this process."""
    shard_counts = []
    models = []
    for shard in SHARDS:
        m = JD.DistributedWord2Vec(rounds=ROUNDS, epochs_per_round=1, **CONF)
        shard_counts.append(m._tokenize_all(shard))
        models.append(m)
    payloads = []
    for toks in shard_counts:
        from collections import Counter
        c = Counter()
        for t in toks:
            c.update(t)
        payloads.append({"counts": dict(c), "total": sum(len(t) for t in toks)})
    monkeypatch.setattr(JD, "_allgather_objects", lambda obj: payloads)
    for m, toks in zip(models, shard_counts):
        m.build_vocab_distributed(toks)
        m._init_params()
    idx = [m._index_sequences(toks) for m, toks in zip(models, shard_counts)]
    for r in range(ROUNDS):
        for m, seqs in zip(models, idx):
            m._run_epochs(seqs, 1, schedule_span=ROUNDS, schedule_offset=r)
        mean = {k: np.mean([np.asarray(m.params[k]) for m in models], axis=0).astype(np.float32)
                for k in models[0].params}
        for m in models:
            m.params = {k: jnp.asarray(v) for k, v in mean.items()}
    return models[0]


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("w2v_gloo")
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"shards": SHARDS, "conf": CONF, "rounds": ROUNDS}, f)
    _spawn_ranks(root, 2)
    ranks = []
    for r in range(2):
        with open(root / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with pytest.MonkeyPatch.context() as mp:
        jm = _jax_two_rounds(mp)
    return ranks, jm


def test_gloo_ranks_merge_the_vocab_as_jax_does(gloo_run):
    ranks, jm = gloo_run
    want = [(w.word, w.count) for w in jm.vocab.words]
    assert "cat" in dict(want) and "dog" in dict(want)
    for res in ranks:
        assert res["vocab"] == want
        assert res["total"] == jm.vocab.total_word_count


def test_gloo_ranks_hold_bit_equal_tables(gloo_run):
    ranks, _ = gloo_run
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v)


def test_gloo_tables_equal_the_jax_average(gloo_run):
    ranks, jm = gloo_run
    for k, v in jm.params.items():
        np.testing.assert_allclose(ranks[0]["params"][k], np.asarray(v), **FIT_TOL)
    init = (np.random.RandomState(CONF["seed"]).rand(len(jm.vocab), 12).astype(np.float32)
            - 0.5) / 12
    # training moved the tables (syn1neg starts at zero)
    assert np.abs(ranks[0]["params"]["syn0"] - init).max() > 1e-5
    assert np.abs(ranks[0]["params"]["syn1neg"]).max() > 1e-3


def test_single_process_is_plain_word2vec_fit():
    corpus = SHARDS[0] + SHARDS[1]
    # one round of 2 epochs (more rounds restart the rate's count of pairs
    # seen from the estimate at each round, in both packages)
    d = DistributedWord2Vec(rounds=1, epochs_per_round=2, device="cpu", **CONF).fit(corpus)
    w = Word2Vec(epochs=2, device="cpu", **CONF).fit(corpus)
    assert [x.word for x in d.vocab.words] == [x.word for x in w.vocab.words]
    np.testing.assert_array_equal(d.syn0, w.syn0)


def test_epochs_kwarg_rejected():
    with pytest.raises(ValueError, match="rounds"):
        DistributedWord2Vec(epochs=5, device="cpu")
