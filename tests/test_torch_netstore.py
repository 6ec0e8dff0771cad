"""The port's coordination stores (``parallel/netstore.py`` and the
``FileStore`` of ``parallel/elastic.py``) against the JAX package's.

The scenarios of tests/test_netstore.py run on the port's classes, each
over both backends (a ``FileStore`` directory and a ``NetStoreServer``
on localhost): lease expiry, first-writer-wins exclusivity, corrupt-frame
drop, watch wakeups and incarnation fencing; then the NetStore-only
semantics (versioned CAS, TTL keys, fail-fast on a dead server, restart
persistence, backend selection). Wire parity: a JAX ``NetStore`` client
against the port's server and the port's client against the JAX server, a
``FileStore`` directory written by one package read by the other, and a
corrupt frame reading as missing in both.
"""

import os
import threading
import time

import pytest
import torch

from deeplearning4j_tpu.parallel import elastic as jelastic
from deeplearning4j_tpu.parallel import netstore as jnetstore
from deeplearning4j_tpu_torch.parallel.elastic import ElasticRuntime, FileStore, Membership
from deeplearning4j_tpu_torch.parallel.netstore import (
    NetStore, NetStoreServer, StoreUnavailable, open_store, store_from_env)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


class _Ctx:
    """A store plus a backend-appropriate way to corrupt one of its
    records in place (torn write / bit rot)."""

    def __init__(self, backend, store, corrupt):
        self.backend = backend
        self.store = store
        self.corrupt = corrupt


@pytest.fixture(params=["file", "tcp"])
def ctx(request, tmp_path):
    if request.param == "file":
        store = FileStore(str(tmp_path / "store"))

        def corrupt(key):
            with open(os.path.join(store.root, key), "r+b") as f:
                f.seek(0)
                f.write(b"ZZZZ")  # clobber the DLES magic

        yield _Ctx("file", store, corrupt)
    else:
        srv = NetStoreServer()
        srv.start()
        store = NetStore(srv.address, fail_after=2.0)

        def corrupt(key):
            # an unframed blob straight through the RPC layer: the server
            # stores payloads opaque, so this lands verbatim
            store._rpc("set", key, payload=b"ZZZZgarbage")

        yield _Ctx("tcp", store, corrupt)
        store.close()
        srv.stop()


# -- the contracts the elastic runtime depends on, both backends ------------

def test_roundtrip_list_prune(ctx):
    s = ctx.store
    s.set("pseg/0/a", b"alpha")
    s.set("pseg/0/b", b"beta")
    s.set_json("view/00000001", {"gen": 1})
    assert s.get("pseg/0/a") == b"alpha"
    assert s.exists("pseg/0/b")
    assert sorted(s.list("pseg/0")) == ["a", "b"]
    assert s.get_json("view/00000001") == {"gen": 1}
    assert s.get("pseg/0/missing") is None
    s.delete("pseg/0/a")
    assert not s.exists("pseg/0/a")
    s.prune("pseg")
    assert s.list("pseg/0") == []
    assert s.exists("view/00000001")


def test_lease_expiry(ctx):
    m = Membership(ctx.store, "w0", ttl=0.25, poll=0.02)
    m._write_lease()
    assert m._fresh(m.lease("w0"))
    time.sleep(0.45)
    assert not m._fresh(m.lease("w0"))


def test_cas_contention(ctx):
    """Exactly one of N concurrent exclusive proposers wins, and the record
    readable afterwards is the winner's payload, whole."""
    wins = []
    barrier = threading.Barrier(6)

    def race(i):
        barrier.wait()
        if ctx.store.set_exclusive("view/00000007", b"proposal-%d" % i):
            wins.append(i)

    threads = [threading.Thread(target=race, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(wins) == 1
    assert ctx.store.get("view/00000007") == b"proposal-%d" % wins[0]


def test_corrupt_frame_drop(ctx):
    ctx.store.set("blob/a", b"payload-bytes")
    assert ctx.store.get("blob/a") == b"payload-bytes"
    ctx.corrupt("blob/a")
    assert ctx.store.get("blob/a") is None   # missing, never garbage


def test_watch_wakeup(ctx):
    s = ctx.store
    token = s.watch("boundary", None)

    def later():
        time.sleep(0.15)
        s.set("boundary/x", b"1")

    t = threading.Thread(target=later)
    t.start()
    t0 = time.monotonic()
    new = s.watch("boundary", token, timeout=5.0)
    waited = time.monotonic() - t0
    t.join(timeout=5)
    assert waited < 3.0, "watch slept through the change"
    assert new != token
    t0 = time.monotonic()
    s.watch("boundary", new, timeout=0.2)   # nothing changed: times out quietly
    assert time.monotonic() - t0 < 2.0


def test_incarnation_fencing(ctx):
    """A relaunched process under the same wid has a fresh lease but a new
    incarnation: the adopted view reads it as dead."""
    rt = ElasticRuntime(ctx.store, "a", ttl=5.0, poll=0.02)
    try:
        v = rt.bootstrap(1, timeout=10)
        assert v.members == ("a",)
        assert rt.member_alive("a")
        imposter = Membership(ctx.store, "a", ttl=5.0, poll=0.02)
        imposter._write_lease()
        assert rt.membership._fresh(rt.membership.lease("a"))
        assert not rt.member_alive("a")
    finally:
        rt.leave()


# -- NetStore-only semantics ---------------------------------------------------

@pytest.fixture
def net(tmp_path):
    srv = NetStoreServer(data_dir=str(tmp_path / "data"))
    srv.start()
    client = NetStore(srv.address, fail_after=1.0)
    yield srv, client
    client.close()
    srv.stop()


def test_versioned_cas(net):
    _, s = net
    assert s.version("k") == 0
    assert s.cas("k", b"v1", 0) == (True, 1)
    assert s.cas("k", b"v2", 0) == (False, 1)     # a stale expectation loses
    assert s.cas("k", b"v2", 1) == (True, 2)
    assert s.get("k") == b"v2"


def test_ttl_key_expiry(net):
    _, s = net
    s.set("ephemeral", b"x", ttl=0.2)
    assert s.exists("ephemeral")
    time.sleep(0.35)
    assert not s.exists("ephemeral")
    assert s.get("ephemeral") is None


def test_fail_fast_store_unavailable(net):
    srv, s = net
    srv.stop()
    t0 = time.monotonic()
    with pytest.raises(StoreUnavailable):
        s.get("anything")
    assert time.monotonic() - t0 < 10.0


def test_server_restart_persistence(tmp_path):
    data = str(tmp_path / "data")
    srv = NetStoreServer(data_dir=data)
    srv.start()
    s = NetStore(srv.address, fail_after=2.0)
    s.set("lease/w0", b"alive")
    s.set_json("view/00000001", {"gen": 1})
    stale_token = s.watch("", None)
    s.close()
    srv.stop()
    srv2 = NetStoreServer(data_dir=data)
    srv2.start()
    s2 = NetStore(srv2.address, fail_after=2.0)
    try:
        assert s2.get("lease/w0") == b"alive"
        assert s2.get_json("view/00000001") == {"gen": 1}
        t0 = time.monotonic()
        s2.watch("", stale_token, timeout=5.0)   # an old server's token: changed
        assert time.monotonic() - t0 < 2.0
    finally:
        s2.close()
        srv2.stop()


def test_open_store_dispatch(tmp_path, monkeypatch):
    assert isinstance(open_store(str(tmp_path / "d")), FileStore)
    assert isinstance(open_store("file:" + str(tmp_path / "d2")), FileStore)
    ns = open_store("tcp://127.0.0.1:19")
    assert isinstance(ns, NetStore) and (ns.host, ns.port) == ("127.0.0.1", 19)
    monkeypatch.setenv("DL4J_TPU_STORE", "tcp://127.0.0.1:21")
    assert isinstance(store_from_env(str(tmp_path / "d")), NetStore)
    monkeypatch.delenv("DL4J_TPU_STORE")
    assert isinstance(store_from_env(str(tmp_path / "d")), FileStore)


# -- wire parity with the JAX package -------------------------------------------

def _exchange(writer, reader):
    writer.set("pseg/3/a", b"\x00\x01payload")
    writer.set_json("view/00000002", {"gen": 2, "members": ["w0", "w1"]})
    assert writer.set_exclusive("view/00000003", b"first")
    assert reader.get("pseg/3/a") == b"\x00\x01payload"
    assert reader.get_json("view/00000002") == {"gen": 2, "members": ["w0", "w1"]}
    assert not reader.set_exclusive("view/00000003", b"second")
    assert reader.get("view/00000003") == b"first"
    assert reader.list("view") == ["00000002", "00000003"]
    reader.set("back/x", b"reply")
    assert writer.get("back/x") == b"reply"


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_clients_of_either_package_share_a_server(server_pkg):
    srv = (NetStoreServer() if server_pkg == "port" else jnetstore.NetStoreServer())
    srv.start()
    port_c = NetStore(srv.address, fail_after=2.0)
    jax_c = jnetstore.NetStore(srv.address, fail_after=2.0)
    try:
        _exchange(jax_c, port_c)
        assert jax_c.cas("k", b"v1", 0) == (True, 1)
        assert port_c.cas("k", b"v2", 1) == (True, 2)
        assert jax_c.get("k") == b"v2" and port_c.version("k") == 2
        # an unframed record reads as missing through both clients
        port_c._rpc("set", "bad", payload=b"ZZZZgarbage")
        assert port_c.get("bad") is None and jax_c.get("bad") is None
    finally:
        port_c.close()
        jax_c.close()
        srv.stop()


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_filestore_directory_reads_in_either_package(writer_pkg, tmp_path):
    root = str(tmp_path / "store")
    port_s, jax_s = FileStore(root), jelastic.FileStore(root)
    writer, reader = (port_s, jax_s) if writer_pkg == "port" else (jax_s, port_s)
    _exchange(writer, reader)
    # the same bytes on disk, frame included
    writer.set("same", b"bytes")
    raw = open(os.path.join(root, "same"), "rb").read()
    reader.set("same", b"bytes")
    assert open(os.path.join(root, "same"), "rb").read() == raw
    # a flipped payload byte fails the CRC in both packages
    path = os.path.join(root, "same")
    data = bytearray(raw)
    data[-1] ^= 0x40
    open(path, "wb").write(bytes(data))
    assert port_s.get("same") is None and jax_s.get("same") is None


def test_leases_and_views_cross_packages(tmp_path):
    """A JAX runtime and a port runtime bootstrap one group on one store:
    the protocol records are the same."""
    store_dir = str(tmp_path / "store")
    a = jelastic.ElasticRuntime(jelastic.FileStore(store_dir), "a", ttl=5.0, poll=0.02)
    b = ElasticRuntime(FileStore(store_dir), "b", ttl=5.0, poll=0.02)
    try:
        views = {}
        tb = threading.Thread(target=lambda: views.setdefault("b", b.bootstrap(2, timeout=20)))
        tb.start()
        va = a.bootstrap(2, timeout=20)
        tb.join(timeout=20)
        assert va.members == views["b"].members == ("a", "b")
        assert va.gen == views["b"].gen
        assert va.to_json() == views["b"].to_json()
    finally:
        a.leave()
        b.leave()
