"""Network-backed coordination store: the fleet half of ``parallel/elastic``.

Host-only copy of ``deeplearning4j_tpu/parallel/netstore.py`` with its
imports pointed at this package; the wire format (``_send_msg`` /
``_recv_msg`` and the ``DLES`` frame) is unchanged, so either package's
client talks to either package's server.

A shared filesystem is an honest network stand-in on localhost and in CI,
but a real fleet has none — membership and payload exchange ride a
coordination service (etcd in Kubernetes fleets, Aeron in the reference
stack). This module is that service as a stdlib-only TCP key-value pair:

- :class:`NetStoreServer` — a threaded TCP server holding framed records in
  memory (optionally mirrored onto a :class:`~.elastic.FileStore` directory
  so a server restart loses nothing), with three etcd-shaped semantics on
  top of plain put/get:

  * **lease** — ``set(key, data, ttl=...)`` records expire ``ttl`` seconds
    after their last write; a heartbeat is just a renewing ``set``.
  * **CAS** — every key carries a version (count of successful writes);
    ``cas(key, data, version)`` writes only when the version still matches,
    and ``set_exclusive`` is CAS-from-absent (version 0): exactly one of any
    number of concurrent creators wins.
  * **watch** — ``watch(prefix, token)`` long-polls server-side until a key
    under ``prefix`` changes past the revision ``token``, replacing tight
    client poll loops with one blocked RPC.

- :class:`NetStore` — the client, exposing the exact ``FileStore`` surface
  (``set/set_exclusive/get/exists/delete/prune/list/*_json``) plus
  ``cas``/``version``/``watch``, so ``Membership``/``ElasticRuntime``/
  ``ElasticTrainer`` run unmodified against either backend. Payloads keep
  the same ``DLES`` CRC framing **end-to-end**: the client frames on write
  and validates on read, so a corrupt blob (bit-rot on the wire or in the
  server's memory/disk) counts and reads as missing — never as junk.

Connection loss is retried with bounded exponential backoff and fails fast
after ``fail_after`` seconds (default: the elastic lease TTL — once the
store has been unreachable that long the group has expelled us anyway, so
dying and rejoining beats hanging). Each thread gets its own socket: the
heartbeat daemon, watch long-polls, and payload prefetchers never serialize
behind one another.

Select a backend with ``DL4J_TPU_STORE`` (``tcp://host:port`` or
``file:/path``; a bare path is a FileStore) or :func:`open_store`.

Observability: ``dl4j_store_rpc_total{op,backend}`` /
``dl4j_store_rpc_retries_total`` counters, ``dl4j_store_watch_wait_seconds``
histogram, ``store_reconnect`` events.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import struct
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.parallel.elastic import (
    FileStore,
    _HEADER,
    _MAGIC,
    elastic_knobs,
)

__all__ = [
    "NetStore",
    "NetStoreServer",
    "StoreUnavailable",
    "open_store",
    "store_from_env",
]


_WIRE = struct.Struct("<I")        # length of the JSON header that follows
_MAX_HEADER = 1 << 20
_MAX_PAYLOAD = 1 << 31
_CHANGE_LOG = 4096                 # retained (rev, key) entries for watch


class StoreUnavailable(ConnectionError):
    """The store server stayed unreachable past the retry deadline. Subclass
    of ConnectionError/OSError so existing heartbeat/except-OSError paths
    degrade the same way they do for a briefly unwritable FileStore."""


# ---------------------------------------------------------------------------
# wire helpers (shared by server and client)
# ---------------------------------------------------------------------------


def _send_msg(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    h = json.dumps(header, sort_keys=True).encode("utf-8")
    sock.sendall(_WIRE.pack(len(h)) + h + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("store connection closed mid-message")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Tuple[dict, bytes]:
    hlen = _WIRE.unpack(_recv_exact(sock, _WIRE.size))[0]
    if hlen > _MAX_HEADER:
        raise ConnectionError(f"store header of {hlen} bytes exceeds limit")
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    nbytes = int(header.get("nbytes", 0))
    if not 0 <= nbytes < _MAX_PAYLOAD:
        raise ConnectionError(f"store payload of {nbytes} bytes out of range")
    payload = _recv_exact(sock, nbytes) if nbytes else b""
    return header, payload


def _under(key: str, prefix: str) -> bool:
    return not prefix or key == prefix or key.startswith(prefix + "/")


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _Record:
    __slots__ = ("data", "ver", "rev", "expire")

    def __init__(self, data: bytes, ver: int, rev: int,
                 expire: Optional[float]):
        self.data = data      # the client-framed blob, stored opaque
        self.ver = ver        # per-key write count (CAS token)
        self.rev = rev        # global revision at last write (watch token)
        self.expire = expire  # wall-clock lease deadline, None = no TTL


class NetStoreServer:
    """Threaded TCP KV server. One handler thread per connection; all state
    behind one lock + condition (watch wakeups). ``data_dir`` mirrors every
    record onto a FileStore so a restarted server resumes with its keys
    (versions restart at 1 and the revision at the key count — stale CAS and
    watch tokens from before the restart are rejected/treated as changed)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 data_dir=None):
        self._host = host
        self._port = int(port)
        self._kv: Dict[str, _Record] = {}
        self._rev = 0
        self._cond = threading.Condition()
        self._log: List[Tuple[int, str]] = []  # (rev, key) ring for watch
        self._disk = FileStore(data_dir) if data_dir else None
        self._srv: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        if self._disk is not None:
            self._load_disk()

    # -- persistence --------------------------------------------------------
    def _load_disk(self) -> None:
        root = self._disk.root
        # Boot-epoch skew: revisions restart ABOVE anything the previous
        # incarnation could have handed out, so a stale watch token always
        # reads as rev < self._rev with an empty change log -> "changed",
        # and a client re-syncs instead of blocking across the restart.
        boot = self._disk.get_json("__meta__/boot") or {}
        epoch = int(boot.get("epoch", 0)) + 1
        self._disk.set_json("__meta__/boot", {"epoch": epoch})
        self._rev = epoch << 32
        for dirpath, _dirs, files in os.walk(root):
            for name in files:
                if name.endswith(".tmp") or ".tmp." in name:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                key = rel.replace(os.sep, "/")
                if key.startswith("__meta__/"):
                    continue
                data = self._disk.get(key)
                if data is None:
                    continue
                self._rev += 1
                self._kv[key] = _Record(data, 1, self._rev, None)

    # -- state transitions (all under self._cond) ---------------------------
    def _live(self, rec: Optional[_Record]) -> bool:
        if rec is None:
            return False
        return rec.expire is None or time.time() < rec.expire  # graftlint: disable=monotonic-clock

    def _bump(self, key: str) -> int:
        self._rev += 1
        self._log.append((self._rev, key))
        if len(self._log) > _CHANGE_LOG:
            del self._log[:len(self._log) - _CHANGE_LOG]
        return self._rev

    def _write(self, key: str, data: bytes, ver: int,
               ttl: Optional[float]) -> _Record:
        expire = (time.time() + float(ttl)) if ttl else None  # graftlint: disable=monotonic-clock
        rec = _Record(data, ver, self._bump(key), expire)
        self._kv[key] = rec
        if self._disk is not None:
            try:
                self._disk.set(key, data)
            except OSError:
                pass  # memory copy stays authoritative for this process
        self._cond.notify_all()
        return rec

    def _drop(self, key: str) -> None:
        if self._kv.pop(key, None) is not None:
            self._bump(key)
            if self._disk is not None:
                try:
                    self._disk.delete(key)
                except OSError:
                    pass
            self._cond.notify_all()

    # -- request dispatch ---------------------------------------------------
    def _handle(self, req: dict, payload: bytes) -> Tuple[dict, bytes]:
        op = req.get("op")
        key = str(req.get("key", ""))
        ttl = req.get("ttl")
        with self._cond:
            if op == "ping":
                return {"ok": True, "rev": self._rev}, b""
            if op == "set":
                rec = self._kv.get(key)
                ver = (rec.ver if self._live(rec) else 0) + 1
                rec = self._write(key, payload, ver, ttl)
                return {"ok": True, "ver": rec.ver, "rev": rec.rev}, b""
            if op == "setx":
                rec = self._kv.get(key)
                if self._live(rec):
                    return {"ok": False, "ver": rec.ver}, b""
                rec = self._write(key, payload, 1, ttl)
                return {"ok": True, "ver": rec.ver, "rev": rec.rev}, b""
            if op == "cas":
                want = int(req.get("ver", 0))
                rec = self._kv.get(key)
                have = rec.ver if self._live(rec) else 0
                if have != want:
                    return {"ok": False, "ver": have}, b""
                rec = self._write(key, payload, have + 1, ttl)
                return {"ok": True, "ver": rec.ver, "rev": rec.rev}, b""
            if op == "get":
                rec = self._kv.get(key)
                if not self._live(rec):
                    return {"exists": False}, b""
                return {"exists": True, "ver": rec.ver,
                        "nbytes": len(rec.data)}, rec.data
            if op == "exists":
                return {"exists": self._live(self._kv.get(key))}, b""
            if op == "ver":
                rec = self._kv.get(key)
                return {"ver": rec.ver if self._live(rec) else 0}, b""
            if op == "delete":
                self._drop(key)
                return {"ok": True}, b""
            if op == "prune":
                for k in [k for k in self._kv if _under(k, key)]:
                    self._drop(k)
                return {"ok": True}, b""
            if op == "list":
                head = (key + "/") if key else ""
                names = set()
                for k, rec in self._kv.items():
                    if k.startswith(head) and self._live(rec):
                        names.add(k[len(head):].split("/", 1)[0])
                return {"names": sorted(names)}, b""
            if op == "watch":
                return self._watch(key, int(req.get("since", 0)),
                                   float(req.get("timeout", 1.0))), b""
        return {"error": f"unknown op {op!r}"}, b""

    def _watch(self, prefix: str, since: int, timeout: float) -> dict:
        # Called with self._cond held. A ``since`` past the current revision
        # (a token from a previous server incarnation) reads as changed so
        # the client re-syncs instead of blocking forever.
        deadline = time.monotonic() + max(0.0, min(timeout, 60.0))
        if since > self._rev:
            return {"rev": self._rev, "changed": True}
        while True:
            if since < self._rev and (not self._log
                                      or self._log[0][0] > since + 1):
                # a revision gap the log cannot account for (ring truncation
                # or a server restart): assume changed
                return {"rev": self._rev, "changed": True}
            for rev, key in self._log:
                if rev > since and _under(key, prefix):
                    return {"rev": self._rev, "changed": True}
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"rev": max(self._rev, since), "changed": False}
            self._cond.wait(remaining)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    while True:
                        req, payload = _recv_msg(sock)
                        if outer._stopped:
                            break  # in-process stop(): act dead to clients
                        resp, data = outer._handle(req, payload)
                        if data:
                            resp = dict(resp, nbytes=len(data))
                        _send_msg(sock, resp, data)
                except (ConnectionError, OSError, ValueError):
                    pass  # client went away / spoke garbage: drop the conn

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server((self._host, self._port), Handler)
        self._host, self._port = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="netstore-server",
            kwargs={"poll_interval": 0.05}, daemon=True)
        self._thread.start()
        return self._host, self._port

    @property
    def address(self) -> str:
        return f"{self._host}:{self._port}"

    @property
    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        self._stopped = True
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._cond:
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class NetStore:
    """FileStore-interface client for :class:`NetStoreServer`.

    Every payload is DLES-framed on write and CRC-validated on read (the
    FileStore corrupt-blob-drop contract, end to end over the wire). RPCs
    retry with bounded exponential backoff on connection errors and raise
    :class:`StoreUnavailable` once the server has been unreachable for
    ``fail_after`` seconds (default: the elastic lease TTL). Sockets are
    per-thread, so a blocked watch long-poll never starves the heartbeat."""

    backend = "tcp"

    def __init__(self, address, *, timeout: float = 10.0,
                 fail_after: Optional[float] = None,
                 retry_base: float = 0.05):
        if isinstance(address, str):
            addr = address[6:] if address.startswith("tcp://") else address
            host, _, port = addr.rpartition(":")
            self.host, self.port = (host or "127.0.0.1"), int(port)
        else:
            self.host, self.port = address[0], int(address[1])
        self.timeout = float(timeout)
        self.fail_after = float(elastic_knobs()["ttl_s"]
                                if fail_after is None else fail_after)
        self.retry_base = float(retry_base)
        self._tls = threading.local()
        self._closed = False

    # -- connection management ---------------------------------------------
    def _conn(self) -> socket.socket:
        sock = getattr(self._tls, "sock", None)
        if sock is None:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._tls.sock = sock
        return sock

    def _drop_conn(self) -> None:
        sock = getattr(self._tls, "sock", None)
        self._tls.sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        self._drop_conn()

    # -- rpc core -----------------------------------------------------------
    def _rpc(self, op: str, key: str = "", *, payload: bytes = b"",
             rpc_timeout: Optional[float] = None, **fields) -> Tuple[
                 dict, bytes]:
        if self._closed:
            raise StoreUnavailable("store client is closed")
        deadline = time.monotonic() + self.fail_after
        delay = self.retry_base
        failures = 0
        req = dict(fields, op=op, key=key, nbytes=len(payload))
        while True:
            try:
                sock = self._conn()
                sock.settimeout(self.timeout if rpc_timeout is None
                                else rpc_timeout + self.timeout)
                _send_msg(sock, req, payload)
                resp, data = _recv_msg(sock)
                if failures:
                    obs.event("store_reconnect", host=self.host,
                              port=self.port, op=op, retries=failures)
                obs.counter("dl4j_store_rpc_total",
                            "Coordination-store operations by op and "
                            "backend", ("op", "backend")).inc(
                                op=op, backend=self.backend)
                if "error" in resp:
                    raise ValueError(f"netstore {op}: {resp['error']}")
                return resp, data
            except (ConnectionError, socket.timeout, OSError) as exc:
                self._drop_conn()
                failures += 1
                obs.counter("dl4j_store_rpc_retries_total",
                            "Coordination-store RPC retries after "
                            "connection errors").inc()
                if time.monotonic() + delay > deadline:
                    raise StoreUnavailable(
                        f"store {self.host}:{self.port} unreachable for "
                        f"{self.fail_after:.1f}s ({op} {key!r}): "
                        f"{exc}") from exc
                time.sleep(delay)
                delay = min(delay * 2, 1.0)

    # -- DLES framing (the FileStore contract, end to end) -------------------
    def _frame(self, data: bytes) -> bytes:
        return _HEADER.pack(_MAGIC, zlib.crc32(data) & 0xFFFFFFFF,
                            len(data)) + data

    def _unframe(self, key: str, raw: bytes) -> Optional[bytes]:
        if len(raw) < _HEADER.size:
            return self._corrupt(key, "short_header")
        magic, crc, length = _HEADER.unpack_from(raw)
        payload = raw[_HEADER.size:]
        if magic != _MAGIC or len(payload) != length:
            return self._corrupt(key, "frame_mismatch")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return self._corrupt(key, "crc_mismatch")
        return payload

    def _corrupt(self, key: str, why: str) -> None:
        obs.counter("dl4j_elastic_store_corrupt_total",
                    "FileStore records failing frame/CRC validation").inc()
        obs.event("elastic_store_corrupt", key=key, reason=why,
                  backend=self.backend)
        return None

    # -- the FileStore surface ----------------------------------------------
    def set(self, key: str, data: bytes, *,
            ttl: Optional[float] = None) -> None:
        self._rpc("set", key, payload=self._frame(data),
                  **({"ttl": float(ttl)} if ttl else {}))

    def set_exclusive(self, key: str, data: bytes) -> bool:
        resp, _ = self._rpc("setx", key, payload=self._frame(data))
        return bool(resp.get("ok"))

    def cas(self, key: str, data: bytes, version: int) -> Tuple[bool, int]:
        """Compare-and-swap on the key's write version (0 = must be absent).
        Returns ``(won, current_version)``."""
        resp, _ = self._rpc("cas", key, payload=self._frame(data),
                            ver=int(version))
        return bool(resp.get("ok")), int(resp.get("ver", 0))

    def version(self, key: str) -> int:
        resp, _ = self._rpc("ver", key)
        return int(resp.get("ver", 0))

    def get(self, key: str) -> Optional[bytes]:
        resp, raw = self._rpc("get", key)
        if not resp.get("exists"):
            return None
        return self._unframe(key, raw)

    def exists(self, key: str) -> bool:
        resp, _ = self._rpc("exists", key)
        return bool(resp.get("exists"))

    def delete(self, key: str) -> None:
        self._rpc("delete", key)

    def prune(self, prefix: str) -> None:
        self._rpc("prune", prefix)

    def list(self, prefix: str) -> List[str]:
        resp, _ = self._rpc("list", prefix)
        return [str(n) for n in resp.get("names", [])]

    # -- JSON convenience ---------------------------------------------------
    def set_json(self, key: str, value: dict) -> None:
        self.set(key, json.dumps(value, sort_keys=True).encode("utf-8"))

    def set_json_exclusive(self, key: str, value: dict) -> bool:
        return self.set_exclusive(
            key, json.dumps(value, sort_keys=True).encode("utf-8"))

    def get_json(self, key: str) -> Optional[dict]:
        raw = self.get(key)
        if raw is None:
            return None
        try:
            return json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return self._corrupt(key, "json_decode")

    # -- watch ---------------------------------------------------------------
    def watch(self, prefix: str, token=None, timeout: float = 1.0):
        """Block until something under ``prefix`` changes relative to
        ``token`` (or ``timeout`` elapses); returns the new opaque token.
        ``token=None`` returns the current state token without waiting."""
        t0 = time.monotonic()
        if token is None:
            resp, _ = self._rpc("ping")
            return int(resp.get("rev", 0))
        resp, _ = self._rpc("watch", prefix, since=int(token),
                            timeout=float(timeout), rpc_timeout=float(timeout))
        obs.histogram("dl4j_store_watch_wait_seconds",
                      "Time spent blocked in store watch calls").observe(
                          time.monotonic() - t0)
        return int(resp.get("rev", 0))


# ---------------------------------------------------------------------------
# backend selection
# ---------------------------------------------------------------------------


def open_store(spec, **net_kwargs):
    """``tcp://host:port`` -> :class:`NetStore`; ``file:/path`` or a bare
    path -> :class:`FileStore`. The one constructor every elastic entry
    point routes through, so the backend is purely a deployment choice."""
    s = os.fspath(spec)
    if s.startswith("tcp://"):
        return NetStore(s, **net_kwargs)
    if s.startswith("file:"):
        s = s[len("file:"):]
    return FileStore(s)


def store_from_env(default=None):
    """Backend from ``DL4J_TPU_STORE`` (falling back to ``default``)."""
    spec = os.environ.get("DL4J_TPU_STORE", default)
    if spec is None:
        raise ValueError("DL4J_TPU_STORE is not set and no default given")
    return open_store(spec)


# ---------------------------------------------------------------------------
# CLI: the server process (``python -m deeplearning4j_tpu_torch.parallel.netstore serve``)
# ---------------------------------------------------------------------------


def _cmd_serve(args) -> int:
    server = NetStoreServer(args.host, args.port, data_dir=args.data)
    host, port = server.start()
    line = f"{host}:{port}"
    if args.announce:
        tmp = f"{args.announce}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, args.announce)
    print(f"netstore listening on {line}", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.parallel.netstore",
        description="TCP coordination-store server for elastic training")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run the KV server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0,
                   help="0 picks a free port (see --announce)")
    s.add_argument("--data", default=None,
                   help="directory to mirror records into (restart safety)")
    s.add_argument("--announce", default=None,
                   help="file to atomically write host:port into once bound")
    s.set_defaults(fn=_cmd_serve)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
