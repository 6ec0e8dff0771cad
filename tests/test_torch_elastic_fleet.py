"""The port's elastic CLI end to end on the CPU: worker processes under
``python -m deeplearning4j_tpu_torch.train.elastic launch --device cpu``.

The load-bearing property is membership invariance: the trajectory is a
function of (seed, data, vshards) alone, so a 2-process run, a shrunken
survivor set, a rejoined worker, a full restart from the distributed
checkpoint and a run over the TCP store all land on the 1-process run's
losses and params bit for bit (``==``, not closeness).

The rejoin scenarios do not race the end of the job: a ``slow_iter``
fault stalls the survivor at the boundary after the shrink for
``REJOIN_STALL_S``, so the relaunched (or partitioned) worker is leasing
again before the survivor's next boundary poll, which grows the view.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.obs import fleet
from deeplearning4j_tpu_torch.train import resilience

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELASTIC = "deeplearning4j_tpu_torch.train.elastic"
# one synthetic workload for every scenario: 6 steps over 24 rows
WORKLOAD = ["--epochs", "2", "--batch", "8", "--n", "24", "--features", "4",
            "--classes", "3", "--hidden", "8", "--lr", "5e-3", "--seed", "7",
            "--vshards", "2", "--poll", "0.02", "--device", "cpu"]
# the survivor's stall after a shrink: a relaunched worker starts (python,
# torch, the port) well inside it on a loaded CPU
REJOIN_STALL_S = 12


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


def _env(chaos=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DL4J_TPU_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if chaos:
        env["DL4J_TPU_CHAOS"] = chaos
    return env


def _launch(root, name, *, workers, world, chaos=None, relaunch=0,
            allow_failures=0, ckpt=None, ckpt_every=0, ttl=2.0, extra=(), store=None):
    """Run the launcher to completion; returns the out dir. ``store``
    overrides the per-scenario FileStore directory (a ``tcp://`` spec)."""
    if store is None:
        store = os.path.join(root, name, "store")
    out = os.path.join(root, name, "out")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", ELASTIC, "launch", "--store", store, "--outdir", out,
           "--workers", str(workers), "--world", str(world), "--relaunch", str(relaunch),
           "--allow-failures", str(allow_failures), "--ttl", str(ttl), "--timeout", "150",
           *WORKLOAD, *extra]
    if ckpt:
        cmd += ["--ckpt-dir", ckpt, "--ckpt-every", str(ckpt_every)]
    r = subprocess.run(cmd, env=_env(chaos), capture_output=True, timeout=180)
    assert r.returncode == 0, (f"launch {name} failed:\n{r.stdout.decode()[-3000:]}"
                               f"\n{r.stderr.decode()[-3000:]}")
    return out


def _result(out, wid="w0"):
    with open(os.path.join(out, f"result_{wid}.json")) as f:
        return json.load(f)


def _params(out, wid="w0"):
    with np.load(os.path.join(out, f"params_{wid}.npz")) as z:
        return {k: z[k] for k in z.files}


def _events(out, wid):
    with open(os.path.join(out, f"events_{wid}.jsonl")) as f:
        return [json.loads(l) for l in f]


def _assert_like_reference(out, baseline, wids, world):
    ref = _result(baseline["out1"])
    want = _params(baseline["out1"])
    for wid in wids:
        got = _result(out, wid)
        assert got["world"] == world, f"{wid} ends at world {got['world']}, not {world}"
        assert got["losses"] == ref["losses"], wid
        p = _params(out, wid)
        assert set(p) == set(want)
        for k in want:
            np.testing.assert_array_equal(p[k], want[k], err_msg=f"{wid}: {k}")


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The uninterrupted 1-process reference (vshards 2, the geometry every
    scenario shares) and a 2-process run writing distributed checkpoints
    every 2 iterations."""
    root = str(tmp_path_factory.mktemp("elastic_fleet"))
    ckpt = os.path.join(root, "ckpt2w")
    out1 = _launch(root, "ref", workers=1, world=1)
    out2 = _launch(root, "ckptrun", workers=2, world=2, ckpt=ckpt, ckpt_every=2)
    return {"root": root, "out1": out1, "out2": out2, "ckpt": ckpt}


def test_two_workers_equal_one_bit_for_bit(baseline):
    ref = _result(baseline["out1"])
    assert ref["iteration"] == 6 and ref["world"] == 1
    _assert_like_reference(baseline["out2"], baseline, ("w0", "w1"), world=2)
    assert _result(baseline["out2"], "w1")["payload_bytes"] > 0


def test_kill_one_worker_shrinks_and_continues(baseline):
    """host_kill SIGKILLs rank 1 at iteration 3; the survivor sees the
    lapsed lease, re-forms at world 1 from the mirror's segments and ends
    on the uninterrupted run's bits."""
    out = _launch(baseline["root"], "kill", workers=2, world=2,
                  chaos="host_kill@iter:3:rank1", allow_failures=1)
    _assert_like_reference(out, baseline, ("w0",), world=1)
    assert _result(out)["gen"] >= 1
    changes = [e for e in _events(out, "w0") if e["kind"] == "membership_change"]
    assert any(e["reason"] == "shrink" and e["removed"] == ["w1"] for e in changes), changes


def test_killed_worker_rejoins_bit_exact(baseline):
    """The launcher relaunches the killed worker; the survivor's stall after
    the shrink holds the boundary until it leases again, the view grows
    back, and the handoff gives both workers the uninterrupted bits."""
    out = _launch(baseline["root"], "rejoin", workers=2, world=2, relaunch=1,
                  chaos=f"host_kill@iter:3:rank1,slow_iter@iter:4:rank0:{REJOIN_STALL_S}")
    _assert_like_reference(out, baseline, ("w0", "w1"), world=2)
    reasons = [e["reason"] for e in _events(out, "w0") if e["kind"] == "membership_change"]
    assert "shrink" in reasons and "grow" in reasons, reasons


def test_corrupt_distributed_shard_falls_back_to_mirror(baseline):
    """A full restart from the 2-process run's distributed checkpoint with
    rank 1's newest shard corrupted: the loader drops it and rank 1's
    segments come from rank 0's mirror; the restart ends on the
    uninterrupted bits."""
    ckpt = baseline["ckpt"]
    tags = sorted(f[len("manifest_"):-len(".json")] for f in os.listdir(ckpt)
                  if f.startswith("manifest_"))
    assert tags, "the 2-process run wrote no distributed checkpoint"
    resilience.corrupt_file(os.path.join(ckpt, f"shard_{tags[-1]}_r1.npz"), mode="bitflip")
    out = _launch(baseline["root"], "restart", workers=2, world=2, ckpt=ckpt, ckpt_every=0)
    _assert_like_reference(out, baseline, ("w0", "w1"), world=2)
    kinds = [e["kind"] for w in ("w0", "w1") for e in _events(out, w)]
    assert "checkpoint_shard_dropped" in kinds and "elastic_restart_restore" in kinds


@contextlib.contextmanager
def _net_server(root):
    """The port's netstore server in its own process; yields its tcp:// spec."""
    announce = os.path.join(root, "netstore.addr")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.netstore", "serve",
         "--host", "127.0.0.1", "--port", "0", "--data", os.path.join(root, "netstore.data"),
         "--announce", announce],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60.0
        while not os.path.exists(announce):
            assert proc.poll() is None, "netstore server died at startup"
            assert time.monotonic() < deadline, "server never announced"
            time.sleep(0.05)
        with open(announce) as f:
            yield "tcp://" + f.read().strip()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_netstore_backend_end_to_end(baseline, tmp_path):
    with _net_server(str(tmp_path)) as spec:
        out = _launch(baseline["root"], "netrun", workers=2, world=2, store=spec)
    assert _result(out)["store_backend"] == "tcp"
    _assert_like_reference(out, baseline, ("w0", "w1"), world=2)


def test_net_partition_expels_and_readmits_bit_exact(baseline):
    """net_partition silences rank 1's heartbeat for 2 s (TTL 1 s): the
    group shrinks, the partition heals during the survivor's stall, rank 1
    is readmitted and both workers end at world 2 on the uninterrupted
    bits."""
    out = _launch(baseline["root"], "partition", workers=2, world=2, ttl=1.0,
                  chaos="net_partition@iter:3:rank1:2.0,"
                        f"slow_iter@iter:4:rank0:{REJOIN_STALL_S // 2}")
    _assert_like_reference(out, baseline, ("w0", "w1"), world=2)
    phases = [e["phase"] for e in _events(out, "w1") if e["kind"] == "elastic_partition"]
    assert phases == ["begin", "end"], phases
    reasons = [e["reason"] for e in _events(out, "w0") if e["kind"] == "membership_change"]
    assert "shrink" in reasons and "grow" in reasons, reasons


def test_fleet_collector_renders_the_workers_snapshots(baseline, capsys):
    store = os.path.join(baseline["root"], "ckptrun", "store")
    assert fleet.main(["render", "--store", store]) == 0
    text = capsys.readouterr().out
    assert "dl4j_fleet_workers 2" in text and 'rank="1"' in text
