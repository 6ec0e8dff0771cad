"""Elastic-of-slices in the port (``train/elastic.py``,
``parallel/mesh_step.py`` ``MeshSlice``) on the CPU: a member is a slice of
two gloo rank processes, its leader holding the lease.

One module fixture runs every launch side by side (``_cmd_launch`` in
threads, each worker a process of the helper below, ``--device cpu``):

- the JAX package's CLI, ``launch --mesh 2 --slice-devices 2`` at world 1
  (the reference: one process on two virtual devices);
- the port at spec ``2``: one slice at world 1 from the JAX CLI model's
  initial params (``interop.params_from_numpy``); two slices; two slices
  with ``slice_kill@iter:3:slice1``; two slices with slice 1's follower
  killed, and stopped, at iteration 3; two slices with ``slice_kill`` and one relaunch
  (the survivor stalls after the shrink so that the relaunched slice
  rejoins); one slice of spec ``2,2`` (model-axis replicas);
- the tiny char-RNN of ``test_torch_elastic.py`` at spec ``2`` (3 real rows
  a vshard, padded to 4: one padded row on rank 1), one slice and two,
  against the JAX package's unsliced ``ElasticTrainer`` in process (a
  slice's payload equals the unsliced vshard's up to reduction order);
- two models with dropout at spec ``2`` (an MLP, and an LSTM whose dense
  layer's dropout sees the ``[b*t, f]`` rows of ``RnnToFeedForward``)
  against the port's unsliced ``ElasticTrainer`` in process: the masks are
  drawn at the whole vshard's shape and cut like the rows;
- two gloo ranks holding ``MeshSlice``'s row arithmetic against the JAX
  package's ``MeshSlice`` on the conftest's CPU devices.

The port's runs are held to the JAX package within ``PARITY`` and to the
port's one-slice run bit for bit (bit-exactness holds across member count
at a fixed spec).
"""

import json
import os
import pickle
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.parallel.mesh_step import MeshSlice as JMeshSlice
from deeplearning4j_tpu.train import elastic as jtrain_elastic
from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
from deeplearning4j_tpu_torch.parallel.mesh_step import MeshSlice
from deeplearning4j_tpu_torch.train import elastic as telastic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = dict(rtol=1e-5, atol=1e-6)   # f32, two packages' kernels
# the JAX tests' workload: 6 steps over 24 rows, 2 vshards of 4 rows
MLP = dict(features=4, hidden="8", classes=3, lr=5e-3, seed=7, n=24)
WORKLOAD = ["--epochs", "2", "--batch", "8", "--n", "24", "--features", "4",
            "--classes", "3", "--hidden", "8", "--lr", "5e-3", "--seed", "7",
            "--vshards", "2", "--poll", "0.02"]
LSTM = dict(vocab_size=11, timesteps=6, hidden=8, updater={"type": "rmsprop", "lr": 1e-2})
LSTM_ROWS, LSTM_BATCH = 12, 6
# the models with dropout: 14 rows, batches of 7 in 2 vshards of 4 rows (the
# second 3 real rows and 1 padded). 4 rows divide over d = 2, so the sliced
# run's vshards hold the rows an unsliced run's do (where ceil(batch /
# vshards) is no multiple of d, the vshards are rounded up to one and hold
# other rows, as in the JAX package; the char-RNN cases cover that)
DROP_ROWS, DROP_BATCH = 14, 7
# the survivor's stall after the shrink: the relaunched slice's two
# processes start (python, torch, the port) well inside it
REJOIN_STALL_S = 12
LAUNCH_TIMEOUT_S = 150

# a worker of these launches: the CLI worker, with the model's initial
# params from a pickle (SLICE_TEST_INIT), the tiny char-RNN and its rows
# (SLICE_TEST_LSTM), a model of the port's from its configuration JSON and
# its rows (SLICE_TEST_MODEL), and a follower sending itself a signal once
# it has the plan of an iteration (SLICE_TEST_FOLLOWER=<id>:<iteration>:KILL|STOP)
HELPER = r'''
import os, pickle, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.train import elastic

args = elastic.parse_args(["worker", *sys.argv[1:]])
model = data = None
if os.environ.get("SLICE_TEST_LSTM"):
    kw, rows, T = pickle.loads(bytes.fromhex(os.environ["SLICE_TEST_LSTM"]))
    model = MultiLayerNetwork(zoo.TextGenerationLSTM(**kw), device="cpu").init()
    ids = np.random.RandomState(3).randint(0, kw["vocab_size"], (rows, T + 1))
    eye = np.eye(kw["vocab_size"], dtype=np.float32)
    data = eye[ids[:, :-1]], eye[ids[:, 1:]]
elif os.environ.get("SLICE_TEST_MODEL"):
    conf, *data = pickle.loads(bytes.fromhex(os.environ["SLICE_TEST_MODEL"]))
    model = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf), device="cpu").init()
else:
    model = elastic._build_model(args)
with open(os.environ["SLICE_TEST_INIT"], "rb") as f:
    params_from_numpy(model, pickle.load(f))
fault = os.environ.get("SLICE_TEST_FOLLOWER")
if fault and args.slice_rank == 1 and args.id == fault.split(":")[0]:
    at, sig = int(fault.split(":")[1]), getattr(signal, "SIG" + fault.split(":")[2])
    recv = elastic.ElasticTrainer._recv_plan

    def _recv_then_signal(self):
        plan = recv(self)
        if plan[0] == elastic._STEP and plan[1] >= at:
            os.kill(os.getpid(), sig)
        return plan

    elastic.ElasticTrainer._recv_plan = _recv_then_signal
elastic.run_worker(args, model=model, data=data)
'''

# two ranks of one slice: MeshSlice's arithmetic, written to <root>/rank<r>.json
ROWS_RANK = r'''
import json, sys
from pathlib import Path
import numpy as np
from deeplearning4j_tpu_torch.parallel import init_distributed, shutdown_distributed
from deeplearning4j_tpu_torch.parallel.mesh_step import MeshSlice

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_distributed(f"file://{root}/store", world, rank, device="cpu", timeout_s=60)
s = MeshSlice("2", device="cpu", timeout_s=30)
c = s.round_rows(3)
out = {"round": [s.round_rows(k) for k in range(1, 10)], "rows": list(s.rows(c)),
       "cut": s.shard_batch(np.arange(c)).tolist(), "leader": s.leader,
       "data_ranks": s.data_ranks}
shutdown_distributed()
(root / f"rank{rank}.json").write_text(json.dumps(out))
'''


def _env(chaos=None, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DL4J_TPU_") and k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", **extra)
    if chaos:
        env["DL4J_TPU_CHAOS"] = chaos
    return env


def _port_launch(root, helper, name, *, workers, init, chaos=None, relaunch=0,
                 allow_failures=0, lstm=False, follower=None, mesh="2", model=None):
    out = os.path.join(root, name)
    argv = ["launch", "--store", os.path.join(out, "store"), "--outdir", out,
            "--workers", str(workers), "--world", str(workers), "--mesh", mesh,
            "--slice-devices", str(MeshSlice.ranks_of(mesh)), "--device", "cpu",
            "--relaunch", str(relaunch), "--allow-failures", str(allow_failures),
            "--ttl", "2.0", "--timeout", str(LAUNCH_TIMEOUT_S), *WORKLOAD]
    extra = {"SLICE_TEST_INIT": init}
    if lstm:
        argv += ["--batch", str(LSTM_BATCH), "--n", str(LSTM_ROWS)]
        extra["SLICE_TEST_LSTM"] = pickle.dumps((LSTM, LSTM_ROWS, LSTM["timesteps"])).hex()
    if model:
        argv += ["--batch", str(DROP_BATCH), "--n", str(DROP_ROWS)]
        extra["SLICE_TEST_MODEL"] = pickle.dumps(model).hex()
    if follower:
        extra["SLICE_TEST_FOLLOWER"] = follower
    rc = telastic._cmd_launch(telastic.parse_args(argv),
                              worker_cmd=[sys.executable, helper],
                              env=_env(chaos, **extra))
    return {"rc": rc, "out": out}


def _jax_cli(root):
    out = os.path.join(root, "jax_cli")
    cmd = [sys.executable, "-m", "deeplearning4j_tpu.train.elastic", "launch",
           "--store", os.path.join(out, "store"), "--outdir", out, "--workers", "1",
           "--world", "1", "--mesh", "2", "--slice-devices", "2", "--ttl", "2.0",
           "--timeout", str(LAUNCH_TIMEOUT_S), *WORKLOAD]
    r = subprocess.run(cmd, env=_env(), capture_output=True, timeout=LAUNCH_TIMEOUT_S + 30)
    return {"rc": r.returncode, "out": out, "log": (r.stdout + r.stderr).decode()[-3000:]}


def _jax_lstm(root):
    """The JAX package's unsliced ElasticTrainer at world 1 on the char-RNN;
    also writes its initial params for the port's runs."""
    jmodel = JNetwork(jzoo.TextGenerationLSTM(**LSTM)).init()
    init = os.path.join(root, "lstm_init.pkl")
    with open(init, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jmodel.params), f)
    ids = np.random.RandomState(3).randint(0, LSTM["vocab_size"],
                                           (LSTM_ROWS, LSTM["timesteps"] + 1))
    eye = np.eye(LSTM["vocab_size"], dtype=np.float32)
    return jmodel, init, (eye[ids[:, :-1]], eye[ids[:, 1:]])


def _dropout_models():
    """``name: (configuration JSON, x, y)`` of the two models with dropout:
    an MLP (dropout on each dense layer's [b, f] input) and an LSTM whose
    dense layer drops from the [b*t, f] rows of RnnToFeedForward."""
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import LSTM as LSTMLayer
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.preprocessors import FeedForwardToRnn, RnnToFeedForward

    V, T = LSTM["vocab_size"], LSTM["timesteps"]
    rs = np.random.RandomState(5)
    mlp = MultiLayerConfiguration(
        layers=(Dense(n_out=8, activation="tanh", dropout=0.3),
                Dense(n_out=8, activation="tanh", dropout=0.5),
                OutputLayer(n_out=3, activation="softmax")),
        input_type=InputType.feed_forward(4), updater={"type": "adam", "lr": 5e-3}, seed=9)
    x = rs.randn(DROP_ROWS, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, DROP_ROWS)]
    rnn = MultiLayerConfiguration(
        layers=(LSTMLayer(n_out=8), RnnToFeedForward(),
                Dense(n_out=8, activation="tanh", dropout=0.5),
                FeedForwardToRnn(timesteps=T), RnnOutputLayer(n_out=V, activation="softmax")),
        input_type=InputType.recurrent(V, T), updater={"type": "adam", "lr": 1e-2}, seed=9)
    ids = rs.randint(0, V, (DROP_ROWS, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return {"drop_mlp": (mlp.to_json(), x, y),
            "drop_rnn": (rnn.to_json(), eye[ids[:, :-1]], eye[ids[:, 1:]])}


def _unsliced_port(root, name, model, init):
    """The port's ``ElasticTrainer`` without a slice at world 1 (2 vshards)
    on ``model`` from ``init``: its result and its params' leaves."""
    from deeplearning4j_tpu_torch.interop import params_from_numpy
    from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    conf, x, y = model
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf), device="cpu").init()
    with open(init, "rb") as f:
        params_from_numpy(net, pickle.load(f))
    tr = telastic.ElasticTrainer(net, os.path.join(root, f"{name}_unsliced_store"), "w0",
                                 world=1, vshards=2, ttl=5.0, poll=0.02)
    try:
        res = tr.fit(x, y, epochs=2, batch_size=DROP_BATCH)
    finally:
        tr.close()
    return dict(res=res, leaves=[l.detach().numpy().copy() for l in tree_leaves(net.params)])


def _result(out, wid="w0"):
    with open(os.path.join(out, f"result_{wid}.json")) as f:
        return json.load(f)


def _params(out, wid="w0"):
    with np.load(os.path.join(out, f"params_{wid}.npz")) as z:
        return {k: z[k] for k in z.files}


def _exits(out, wid, incarnation=0):
    """How the launcher saw slice ``wid``'s ranks end: their exit codes and
    the ranks it killed itself."""
    with open(os.path.join(out, f"slice_{wid}_{incarnation}", "exits.json")) as f:
        return json.load(f)


def _events(out, wid):
    with open(os.path.join(out, f"events_{wid}.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic_slices"))
    helper = os.path.join(root, "worker.py")
    with open(helper, "w") as f:
        f.write(HELPER)
    # the JAX CLI model's initial params (threefry init is deterministic)
    jmlp = jtrain_elastic._build_model(SimpleNamespace(**MLP))
    mlp_init = os.path.join(root, "mlp_init.pkl")
    with open(mlp_init, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jmlp.params), f)
    jlstm, lstm_init, lstm_data = _jax_lstm(root)
    from deeplearning4j_tpu_torch.interop import params_to_numpy
    from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork

    drops, drop_inits = _dropout_models(), {}
    for name, (conf, _, _) in drops.items():
        drop_inits[name] = os.path.join(root, f"{name}_init.pkl")
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf), device="cpu").init()
        with open(drop_inits[name], "wb") as f:
            pickle.dump(params_to_numpy(net), f)
    rows_root = os.path.join(root, "rows")
    os.makedirs(rows_root)
    rows_script = os.path.join(root, "rows_rank.py")
    with open(rows_script, "w") as f:
        f.write(ROWS_RANK)

    got, errors = {}, []
    jobs = {
        "jax_cli": lambda: _jax_cli(root),
        "ref": lambda: _port_launch(root, helper, "ref", workers=1, init=mlp_init),
        "two": lambda: _port_launch(root, helper, "two", workers=2, init=mlp_init),
        "kill": lambda: _port_launch(root, helper, "kill", workers=2, init=mlp_init,
                                     chaos="slice_kill@iter:3:slice1", allow_failures=1),
        "follower": lambda: _port_launch(root, helper, "follower", workers=2, init=mlp_init,
                                         follower="w1:3:KILL", allow_failures=1),
        "hung": lambda: _port_launch(root, helper, "hung", workers=2, init=mlp_init,
                                     follower="w1:3:STOP", allow_failures=1),
        "rejoin": lambda: _port_launch(
            root, helper, "rejoin", workers=2, init=mlp_init, relaunch=1,
            chaos=f"slice_kill@iter:3:slice1,slow_iter@iter:4:rank0:{REJOIN_STALL_S}"),
        "spec22": lambda: _port_launch(root, helper, "spec22", workers=1, init=mlp_init,
                                       mesh="2,2"),
        "lstm1": lambda: _port_launch(root, helper, "lstm1", workers=1, init=lstm_init,
                                      lstm=True),
        "lstm2": lambda: _port_launch(root, helper, "lstm2", workers=2, init=lstm_init,
                                      lstm=True),
        "rows": lambda: spawn_ranks([sys.executable, rows_script], 2, rows_root, 120,
                                    env=_env()),
    }
    for name in drops:
        jobs[name] = (lambda name=name: _port_launch(
            root, helper, name, workers=1, init=drop_inits[name], model=drops[name]))

    def run(name, fn):
        try:
            got[name] = fn()
        except BaseException as e:   # noqa: BLE001 (re-raised below)
            errors.append((name, e))

    threads = [threading.Thread(target=run, args=item) for item in jobs.items()]
    for th in threads:
        th.start()
    # meanwhile, in this process: the JAX package's unsliced trainer on the
    # char-RNN (world 1, 2 vshards), the slices' reference
    tr = jtrain_elastic.ElasticTrainer(jlstm, os.path.join(root, "jax_lstm_store"), "w0",
                                       world=1, vshards=2, ttl=5.0, poll=0.02)
    try:
        got["jax_lstm"] = dict(res=tr.fit(*lstm_data, epochs=2, batch_size=LSTM_BATCH),
                               leaves=[np.asarray(l) for l in
                                       jax.tree_util.tree_leaves(jlstm.params)])
    finally:
        tr.close()
    # and the port's unsliced trainer on the models with dropout
    for name in drops:
        got[f"{name}_unsliced"] = _unsliced_port(root, name, drops[name], drop_inits[name])
    for th in threads:
        th.join()
    if errors:
        raise errors[0][1]
    got["rows"] = [json.load(open(os.path.join(rows_root, f"rank{r}.json"))) for r in (0, 1)]
    return got


def _launched(runs, name):
    r = runs[name]
    assert r["rc"] == 0, f"launch {name} returned {r['rc']}: {r.get('log', '')}"
    return r["out"]


def _assert_params_equal(a, b, what):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def _assert_like_ref(runs, name, wids, world):
    ref_out = _launched(runs, "ref")
    out = _launched(runs, name)
    ref = _result(ref_out)
    for wid in wids:
        got = _result(out, wid)
        assert got["world"] == world, f"{name} {wid} ends at world {got['world']}"
        assert got["losses"] == ref["losses"], f"{name} {wid}"
        _assert_params_equal(_params(out, wid), _params(ref_out), f"{name} {wid}")
    return out


def test_one_slice_matches_the_jax_cli_slice(runs):
    """(1) The port's slice of spec 2 at world 1 against the JAX CLI's
    ``--mesh 2 --slice-devices 2`` run from the same initial params."""
    j_out, p_out = _launched(runs, "jax_cli"), _launched(runs, "ref")
    j, p = _result(j_out), _result(p_out)
    assert p["iteration"] == j["iteration"] == 6
    assert p["world"] == j["world"] == 1
    assert p["slice"] == "2" and p["slice_ranks"] == 2
    np.testing.assert_allclose(p["losses"], j["losses"], **PARITY)
    jp, pp = _params(j_out), _params(p_out)
    assert set(jp) == set(pp)
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], err_msg=k, **PARITY)
    # only the leader writes
    assert sorted(f for f in os.listdir(p_out) if f.endswith((".npz", ".json", ".jsonl"))) \
        == ["events_w0.jsonl", "params_w0.npz", "result_w0.json"]


def test_two_slices_equal_one_bit_for_bit(runs):
    """(2) Two slices of spec 2, no fault: bit-equal to one."""
    _assert_like_ref(runs, "two", ("w0", "w1"), world=2)


def test_slice_kill_shrinks_to_the_survivor_bit_exact(runs):
    """(3) ``slice_kill@iter:3:slice1`` kills slice 1's process group (its
    leader and its follower); the survivor shrinks to world 1 and ends on
    the one-slice bits."""
    out = _assert_like_ref(runs, "kill", ("w0",), world=1)
    assert not os.path.exists(os.path.join(out, "result_w1.json"))
    # both of slice 1's ranks died of the kill: none was left to the launcher
    assert _exits(out, "w1") == {"rcs": [-9, -9], "killed": []}
    assert _exits(out, "w0")["rcs"] == [0, 0]
    kinds = [e["kind"] for e in _events(out, "w1")]
    assert "slice_kill" in kinds
    changes = [e for e in _events(out, "w0") if e["kind"] == "membership_change"]
    assert any(e["reason"] == "shrink" and e["removed"] == ["w1"] for e in changes), changes


def test_a_dead_follower_takes_its_slice_out(runs):
    """(4) Slice 1's follower (not its leader) dies at iteration 3: the
    leader's gather fails, it drops its lease and exits non-zero without
    publishing that step; the group shrinks and the survivor ends on the
    one-slice bits."""
    out = _assert_like_ref(runs, "follower", ("w0",), world=1)
    assert not os.path.exists(os.path.join(out, "result_w1.json"))
    rcs = _exits(out, "w1")["rcs"]
    assert rcs[1] == -9 and rcs[0] != 0, rcs
    lost = [e for e in _events(out, "w1") if e["kind"] == "elastic_slice_failed"]
    assert lost and lost[0]["slice_rank"] == 0
    changes = [e for e in _events(out, "w0") if e["kind"] == "membership_change"]
    assert any(e["reason"] == "shrink" and e["removed"] == ["w1"] for e in changes), changes


def test_a_hung_follower_times_its_slice_out(runs):
    """Slice 1's follower stops (SIGSTOP) at iteration 3: the leader's
    gather times out after ``SLICE_TIMEOUT_TTLS`` lease TTLs, the slice
    ends and the survivor shrinks to the one-slice bits."""
    out = _assert_like_ref(runs, "hung", ("w0",), world=1)
    lost = [e for e in _events(out, "w1") if e["kind"] == "elastic_slice_failed"]
    assert lost and lost[0]["slice_rank"] == 0
    assert "imed out" in lost[0]["error"], lost[0]["error"]
    # the stopped follower outlived its leader: the launcher killed it
    exits = _exits(out, "w1")
    assert exits["killed"] == [1] and exits["rcs"][0] not in (0, None), exits


def test_a_relaunched_slice_rejoins_bit_exact(runs):
    """(5) The killed slice is relaunched (a new incarnation, a new slice
    store); its leader rejoins through the handoff and broadcasts what it
    took to its follower. Both slices end at world 2 on the one-slice
    bits."""
    out = _assert_like_ref(runs, "rejoin", ("w0", "w1"), world=2)
    reasons = [e["reason"] for e in _events(out, "w0") if e["kind"] == "membership_change"]
    assert "shrink" in reasons and "grow" in reasons, reasons
    assert _exits(out, "w1", 0) == {"rcs": [-9, -9], "killed": []}
    assert _exits(out, "w1", 1)["rcs"] == [0, 0]


def test_model_axis_replicas_are_left_out_of_the_sum(runs):
    """Spec ``2,2``: four ranks, the two ``model`` replicas of each ``data``
    coordinate compute the same rows and only one part per coordinate is
    summed, so the run is bit-equal to spec ``2``'s."""
    out = _assert_like_ref(runs, "spec22", ("w0",), world=1)
    assert _result(out)["slice_ranks"] == 4


@pytest.mark.parametrize("name", ["lstm1", "lstm2"])
def test_char_rnn_slices_match_the_unsliced_jax_trainer(runs, name):
    """The char-RNN with 3 real rows a vshard (padded to 4; rank 1 holds one
    real and one padded row): the slices' losses and params within PARITY
    of the JAX package's unsliced vshards, and two slices bit-equal to
    one."""
    j = runs["jax_lstm"]
    out = _launched(runs, name)
    wids = ("w0",) if name == "lstm1" else ("w0", "w1")
    for wid in wids:
        p = _result(out, wid)
        assert p["iteration"] == j["res"]["iteration"] == 4
        np.testing.assert_allclose(p["losses"], j["res"]["losses"], **PARITY)
        got = _params(out, wid)
        leaves = [got[k] for k in sorted(got, key=lambda k: tuple(int(v) for v in
                                                                 k[1:].split("_")))]
        assert len(leaves) == len(j["leaves"])
        for a, b in zip(leaves, j["leaves"]):
            np.testing.assert_allclose(a, b, **PARITY)
    if name == "lstm2":
        one = _launched(runs, "lstm1")
        assert _result(out)["losses"] == _result(one)["losses"]
        _assert_params_equal(_params(out), _params(one), "lstm2 vs lstm1")


@pytest.mark.parametrize("name", ["drop_mlp", "drop_rnn"])
def test_dropout_slices_match_the_unsliced_trainer(runs, name):
    """Dropout in a slice of spec 2: each rank keeps its rows of a mask
    drawn at the whole vshard's shape (``[b*t, f]`` behind RnnToFeedForward:
    rows ``[lo*t, hi*t)``), so one slice at world 1 ends within PARITY of
    the port's unsliced trainer (rank 1 of the second vshard holds one real
    and one padded row)."""
    want = runs[f"{name}_unsliced"]
    out = _launched(runs, name)
    p = _result(out)
    assert p["slice_ranks"] == 2 and p["iteration"] == want["res"]["iteration"] == 4
    np.testing.assert_allclose(p["losses"], want["res"]["losses"], **PARITY)
    got = _params(out)
    leaves = [got[k] for k in sorted(got, key=lambda k: tuple(int(v) for v in
                                                             k[1:].split("_")))]
    assert len(leaves) == len(want["leaves"])
    for a, b in zip(leaves, want["leaves"]):
        np.testing.assert_allclose(a, b, **PARITY)


@pytest.mark.parametrize("shape, cut, kept", [
    ((3, 4), (6, 3, 6), ((6, 4), 3, 6)),             # the rows themselves
    ((15, 4), (6, 3, 6), ((30, 4), 15, 30)),         # [b*t, f], t = 5
    ((2, 1, 1, 4), (4, 0, 2), ((4, 1, 1, 4), 0, 2)),  # spatial dropout's draw
    ((6, 4), (6, 0, 6), ((6, 4), 0, 6)),             # the whole batch: no cut
    ((6, 4), (4, 2, 4), ((12, 4), 6, 12)),           # t = 3, the last rows
])
def test_batch_draw_keeps_the_cut_rows_of_the_whole_draw(shape, cut, kept):
    """``batch_draw`` under ``row_cut``: a leading axis of k times the cut's
    rows is drawn at k times the whole batch's rows and cut."""
    from deeplearning4j_tpu_torch.nn.config import batch_draw, row_cut

    with row_cut(*cut):
        got = batch_draw(torch.rand, shape, generator=torch.Generator().manual_seed(4))
    whole, lo, hi = kept
    want = torch.rand(whole, generator=torch.Generator().manual_seed(4))[lo:hi]
    assert got.shape == shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_batch_draw_refuses_a_shape_it_cannot_cut():
    """A leading axis that is no multiple of the cut's rows raises instead
    of drawing the same values on every rank."""
    from deeplearning4j_tpu_torch.nn.config import batch_draw, row_cut

    with row_cut(6, 3, 6), pytest.raises(ValueError, match="not a multiple"):
        batch_draw(torch.rand, (4, 2), generator=torch.Generator().manual_seed(0))
    assert batch_draw(torch.rand, (4, 2)).shape == (4, 2)    # no cut, any shape


def test_mesh_slice_rows_match_the_jax_mesh_slice(runs):
    """(6) ``round_rows`` and the row cut at d = 2 on an odd vshard (3 rows,
    padded to 4) against the JAX package's ``MeshSlice`` on two CPU
    devices: the rows each data coordinate holds."""
    js = JMeshSlice("2", devices=jax.devices()[:2])
    want_round = [js.round_rows(k) for k in range(1, 10)]
    c = js.round_rows(3)
    placed = js.shard_batch(np.arange(c))
    by_device = {s.device: np.asarray(s.data).tolist() for s in placed.addressable_shards}
    want_cut = [by_device[d] for d in js.mesh.devices.reshape(-1)]
    for r, got in enumerate(runs["rows"]):
        assert got["round"] == want_round
        assert got["cut"] == want_cut[r]
        lo, hi = got["rows"]
        assert list(range(lo, hi)) == want_cut[r]
        assert got["leader"] == (r == 0) and got["data_ranks"] == [0, 1]


def test_launcher_wants_one_process_a_slice_rank(tmp_path):
    """``--mesh`` of d·t·s ranks needs ``--slice-devices d·t·s``; a spec of
    one rank needs no process group."""
    assert MeshSlice.ranks_of("2,2") == 4 and MeshSlice.ranks_of(None) == 1
    for devices in ("0", "4"):
        args = telastic.parse_args(["launch", "--store", str(tmp_path / "s"), "--outdir",
                                    str(tmp_path / "o"), "--mesh", "2", "--device", "cpu",
                                    "--slice-devices", devices])
        with pytest.raises(ValueError, match="--slice-devices must be 2"):
            telastic._cmd_launch(args)
    model = telastic._build_model(SimpleNamespace(device="cpu", **MLP))
    tr = telastic.ElasticTrainer(model, str(tmp_path), "w0", slice_spec="1,1")
    assert tr.leader and tr.slice.size == 1 and not torch.distributed.is_initialized()
    tr.close()
