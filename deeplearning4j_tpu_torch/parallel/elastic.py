"""Elastic membership runtime for multi-process data-parallel training
(host-only copy of ``deeplearning4j_tpu/parallel/elastic.py`` with its
imports pointed at this package).

A **lease-based rendezvous** on a shared coordination store, on top of
which ``train/elastic.py`` runs the gradient exchange (optionally ternary
compressed) and the sharded optimizer update (arXiv 2004.13336) at
whatever world size is currently alive.

Why not one ``torch.distributed`` group: its world is fixed at init — a
lost process wedges every collective and the group cannot re-form at a
reduced size. Elasticity therefore lives ABOVE the collectives: each worker
is its own single-process PyTorch instance on its device, and the
cross-host exchange moves explicit payloads through a :class:`FileStore` —
a CRC-framed, atomically-renamed key/value directory that stands in for the
data-centre network (``parallel/netstore.py`` is the TCP store).

The membership protocol:

- **Leases** (``lease/<wid>``): each worker heartbeats a wall-clock
  timestamped lease every ``ttl/4`` seconds from a daemon thread. A worker
  whose lease is older than its TTL is dead to the group. The heartbeat
  thread can be suspended (``Membership.suspend``) — that IS the
  ``net_partition`` chaos fault: the worker keeps computing but its lease
  goes stale, exactly like a worker on the wrong side of a switch failure.
- **Views** (``view/<gen>``): membership agreement is a monotonic sequence
  of generation-numbered views, each recording ``members``,
  ``prev_members``, and the **sync point** (epoch/step/iteration) where the
  new world takes over. A view is proposed by the *coordinator* — the
  lowest worker id among live holders of the current view — via an
  exclusive create, so concurrent proposals for the same generation resolve
  to exactly one winner. Joiners cannot coordinate: only a state-holding
  member may propose, because the proposer's sync point must come from live
  training state.
- **Changes** surface as :class:`MembershipChanged` carrying the new view;
  the trainer drains to its step boundary, re-forms (re-sharding optimizer
  segments, see ``train/elastic.py``), and continues. A worker that finds
  itself expelled (partition healed after the TTL) re-leases and waits for
  the survivors to grow the view back around it — the in-process rejoin.

The store records are byte-for-byte the JAX package's (the same ``DLES``
frame, keys and JSON), so a store directory written by one package reads
in the other.

Observability: ``dl4j_workers_active`` gauge, ``dl4j_elastic_shrink_total``
/ ``dl4j_elastic_rejoin_total`` counters, ``dl4j_store_rpc_total{op,
backend}``, ``dl4j_elastic_store_corrupt_total``, the
``dl4j_store_watch_wait_seconds`` histogram, and ``membership_change``
JSONL events with rank/lease/epoch fields.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch import obs

__all__ = [
    "ElasticRuntime",
    "FileStore",
    "Membership",
    "MembershipChanged",
    "View",
    "elastic_knobs",
]


def elastic_knobs() -> dict:
    """Env-tunable membership timing."""
    return {
        "ttl_s": float(os.environ.get("DL4J_TPU_ELASTIC_TTL_S", "10.0")),
        "poll_s": float(os.environ.get("DL4J_TPU_ELASTIC_POLL_S", "0.05")),
        "boot_timeout_s": float(
            os.environ.get("DL4J_TPU_ELASTIC_BOOT_TIMEOUT_S", "120.0")),
        "wait_timeout_s": float(
            os.environ.get("DL4J_TPU_ELASTIC_WAIT_TIMEOUT_S", "600.0")),
    }


# ---------------------------------------------------------------------------
# FileStore: CRC-framed atomic KV on a shared directory
# ---------------------------------------------------------------------------


_MAGIC = b"DLES"
_HEADER = struct.Struct("<4sIQ")  # magic, crc32(payload), payload length

_LINK_FALLBACK_WARNED = False


def _count_rpc(op: str, backend: str) -> None:
    obs.counter("dl4j_store_rpc_total",
                "Coordination-store operations by op and backend",
                ("op", "backend")).inc(op=op, backend=backend)


class FileStore:
    """Shared coordination/payload store.

    Every record is framed ``magic | crc32 | length | payload`` and lands via
    write-to-tempfile + ``os.replace`` (or ``os.link`` for exclusive
    creates), so a reader sees either nothing or a whole, checksummed record
    — never a torn write. Keys are slash-separated paths under ``root``.

    The same interface (plus :meth:`watch`) is implemented over TCP by
    ``parallel/netstore.NetStore``; pick a backend with
    ``parallel.netstore.open_store`` / ``DL4J_TPU_STORE``.
    """

    backend = "file"

    def __init__(self, root):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)

    # -- paths --------------------------------------------------------------
    def _path(self, key: str) -> str:
        p = os.path.join(self.root, key)
        d = os.path.dirname(p)
        if d:
            os.makedirs(d, exist_ok=True)
        return p

    def _frame(self, data: bytes) -> bytes:
        return _HEADER.pack(_MAGIC, zlib.crc32(data) & 0xFFFFFFFF,
                            len(data)) + data

    def _tmp(self, path: str) -> str:
        return f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"

    # -- writes -------------------------------------------------------------
    def set(self, key: str, data: bytes) -> None:
        """Last-writer-wins atomic put (leases, payloads, manifests)."""
        _count_rpc("set", self.backend)
        path = self._path(key)
        tmp = self._tmp(path)
        with open(tmp, "wb") as f:
            f.write(self._frame(data))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def set_exclusive(self, key: str, data: bytes) -> bool:
        """First-writer-wins atomic put (view proposals). Returns True when
        THIS call created the record — the link is atomic, so exactly one of
        any number of concurrent proposers wins. Filesystems without
        hardlinks (FAT, some NFS exports) fall back to an ``O_EXCL``
        create: exclusivity holds, but the record is written in place, so a
        concurrent reader can catch it half-written — the CRC frame makes
        that read as missing, and the reader retries."""
        _count_rpc("setx", self.backend)
        path = self._path(key)
        tmp = self._tmp(path)
        framed = self._frame(data)
        with open(tmp, "wb") as f:
            f.write(framed)
            f.flush()
            os.fsync(f.fileno())
        try:
            try:
                os.link(tmp, path)
                return True
            except FileExistsError:
                return False
            except OSError:
                return self._set_exclusive_o_excl(path, framed)
        finally:
            os.unlink(tmp)

    def _set_exclusive_o_excl(self, path: str, framed: bytes) -> bool:
        global _LINK_FALLBACK_WARNED
        if not _LINK_FALLBACK_WARNED:
            _LINK_FALLBACK_WARNED = True
            warnings.warn(
                f"FileStore at {self.root!r}: os.link unsupported; exclusive "
                f"creates fall back to O_EXCL (exclusivity preserved, "
                f"in-place write guarded by CRC framing)",
                RuntimeWarning, stacklevel=3)
            obs.event("elastic_store_link_fallback", root=self.root)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "wb") as f:
            f.write(framed)
            f.flush()
            os.fsync(f.fileno())
        return True

    # -- reads --------------------------------------------------------------
    def get(self, key: str) -> Optional[bytes]:
        """The record's payload, or None when missing. A record failing its
        CRC (torn external copy, disk fault) counts + reads as missing
        rather than poisoning the consumer."""
        _count_rpc("get", self.backend)
        path = os.path.join(self.root, key)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except (FileNotFoundError, NotADirectoryError):
            return None
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

    def exists(self, key: str) -> bool:
        _count_rpc("exists", self.backend)
        return os.path.isfile(os.path.join(self.root, key))

    def delete(self, key: str) -> None:
        _count_rpc("delete", self.backend)
        try:
            os.unlink(os.path.join(self.root, key))
        except FileNotFoundError:
            pass

    def prune(self, prefix: str) -> None:
        """Best-effort recursive delete of a key subtree (step-payload GC).
        Concurrent readers are safe: records land by rename, so a reader
        either already opened the file (unlink doesn't revoke it) or sees a
        miss and falls into its normal wait path."""
        import shutil

        _count_rpc("prune", self.backend)
        shutil.rmtree(os.path.join(self.root, prefix), ignore_errors=True)

    def list(self, prefix: str) -> List[str]:
        """Sorted record names directly under the ``prefix`` directory."""
        _count_rpc("list", self.backend)
        d = os.path.join(self.root, prefix)
        try:
            names = os.listdir(d)
        except (FileNotFoundError, NotADirectoryError):
            return []
        return sorted(n for n in names if not n.endswith(".tmp")
                      and ".tmp." not in n)

    # -- watch ---------------------------------------------------------------
    def _fingerprint(self, prefix: str) -> Tuple:
        """State token for :meth:`watch`: (name, mtime_ns, size) of the
        entries directly under ``prefix``. Renaming a record into a
        subdirectory bumps that subdirectory's mtime, so watching ``""``
        observes changes anywhere in the tree one level down."""
        d = os.path.join(self.root, prefix) if prefix else self.root
        entries = []
        try:
            with os.scandir(d) as it:
                for e in it:
                    if e.name.endswith(".tmp") or ".tmp." in e.name:
                        continue
                    try:
                        st = e.stat()
                    except OSError:
                        continue
                    entries.append((e.name, st.st_mtime_ns, st.st_size))
        except (FileNotFoundError, NotADirectoryError):
            pass
        return tuple(sorted(entries))

    def watch(self, prefix: str, token=None, timeout: float = 1.0):
        """Block until something under ``prefix`` changes relative to
        ``token`` (or ``timeout`` elapses); returns the new opaque token.
        ``token=None`` returns the current token without waiting. The
        file backend polls directory fingerprints; the TCP backend long-
        polls a server revision — same contract, so membership waits are
        backend-agnostic."""
        _count_rpc("watch", self.backend)
        t0 = time.monotonic()
        cur = self._fingerprint(prefix)
        if token is None:
            return cur
        deadline = t0 + max(0.0, float(timeout))
        step = min(max(float(timeout) / 10.0, 0.005), 0.05)
        while cur == token:
            now = time.monotonic()
            if now >= deadline:
                break
            time.sleep(min(step, deadline - now))
            cur = self._fingerprint(prefix)
        obs.histogram("dl4j_store_watch_wait_seconds",
                      "Time spent blocked in store watch calls").observe(
                          time.monotonic() - t0)
        return cur

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


# ---------------------------------------------------------------------------
# Leases + heartbeat
# ---------------------------------------------------------------------------


class Membership:
    """One worker's lease on the group, renewed from a daemon thread.

    Lease timestamps are WALL clock by necessity — they are compared across
    processes, where no shared monotonic clock exists. All cross-process
    staleness math therefore lives in :meth:`_fresh`; purely local waits use
    ``time.monotonic()``.
    """

    def __init__(self, store: FileStore, wid: str, *, ttl: float,
                 poll: float, rack: str = ""):
        self.store = store
        self.wid = wid
        self.ttl = float(ttl)
        self.poll = float(poll)
        self.rack = str(rack)
        self.incarnation = f"{os.getpid()}.{int(time.time() * 1e6)}"  # graftlint: disable=monotonic-clock
        self._stop = threading.Event()
        self._suspend_until = 0.0       # monotonic deadline; 0 = not suspended
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -- lease record -------------------------------------------------------
    def _write_lease(self) -> None:
        self.store.set_json(f"lease/{self.wid}", {
            "wid": self.wid,
            "ts": time.time(),  # graftlint: disable=monotonic-clock
            "ttl": self.ttl,
            "inc": self.incarnation,
            "rack": self.rack,
        })

    def _fresh(self, lease: Optional[dict]) -> bool:
        if not lease:
            return False
        age = time.time() - float(lease.get("ts", 0.0))  # graftlint: disable=monotonic-clock
        return age <= float(lease.get("ttl", self.ttl))

    # -- lifecycle ----------------------------------------------------------
    def join(self) -> None:
        """Write the first lease and start heartbeating. Re-entrant: a
        rejoining worker gets a fresh incarnation token."""
        self.incarnation = f"{os.getpid()}.{int(time.time() * 1e6)}"  # graftlint: disable=monotonic-clock
        self._write_lease()
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._heartbeat_loop, name=f"elastic-hb-{self.wid}",
                daemon=True)
            self._thread.start()

    def leave(self, timeout: Optional[float] = None) -> None:
        """Stop heartbeating, join the thread with a deadline (a heartbeat
        mid-RPC against an unreachable store can take up to its retry
        budget), then drop the lease best-effort."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=(2 * self.poll + 1.0)
                              if timeout is None else float(timeout))
            if self._thread.is_alive():
                obs.event("elastic_heartbeat_leak", wid=self.wid)
            self._thread = None
        try:
            self.store.delete(f"lease/{self.wid}")
        except OSError:
            pass  # store already gone; the lease will expire on its own

    def _heartbeat_loop(self) -> None:
        interval = max(self.ttl / 4.0, self.poll)
        while not self._stop.wait(interval):
            # check-and-renew under the lock: a suspend() landing between an
            # unlocked check and the write would be overridden by a renewal,
            # un-partitioning the worker mid-fault
            with self._lock:
                if time.monotonic() < self._suspend_until:
                    continue
                try:
                    self._write_lease()
                except OSError:
                    # store briefly unwritable: skip this beat; the TTL gives
                    # us ttl/interval more chances before anyone expels us
                    pass

    def suspend(self, seconds: float) -> None:
        """Stop renewing the lease for ``seconds`` (the net_partition /
        rack_partition chaos faults). The worker process keeps running; to
        the rest of the group it looks exactly like a network partition."""
        with self._lock:
            self._suspend_until = time.monotonic() + float(seconds)

    def heartbeat_now(self) -> None:
        """Synchronous renewal (called after a partition heals so rejoin
        does not wait for the next thread tick)."""
        with self._lock:
            self._suspend_until = 0.0
            self._write_lease()

    # -- group queries -------------------------------------------------------
    def lease(self, wid: str) -> Optional[dict]:
        return self.store.get_json(f"lease/{wid}")

    def live(self) -> List[str]:
        """Sorted worker ids whose lease is fresh right now."""
        out = []
        for name in self.store.list("lease"):
            if self._fresh(self.store.get_json(f"lease/{name}")):
                out.append(name)
        return sorted(out)

    def expired(self, wid: str) -> bool:
        return not self._fresh(self.lease(wid))


# ---------------------------------------------------------------------------
# Views
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class View:
    """One agreed membership generation and the sync point it starts at.

    ``incs`` records each member's lease *incarnation* (a per-process join
    token). A worker killed and relaunched under the same id re-leases with
    a fresh incarnation BEFORE the survivors notice the death; without the
    token they would keep waiting on a "live" member whose training state is
    gone. A member is therefore alive only while its lease is fresh AND its
    incarnation still matches the view's — a restarted process reads as
    dead-then-joiner, never as a state holder.
    """

    gen: int
    members: Tuple[str, ...]
    prev_members: Tuple[str, ...]
    epoch: int
    step: int
    iteration: int
    reason: str
    rejoined: Tuple[str, ...] = ()
    incs: Dict[str, str] = field(default_factory=dict)
    prev_incs: Dict[str, str] = field(default_factory=dict)
    # rack labels per member (DL4J_TPU_RACK), recorded at proposal time so
    # every member derives the SAME rack-aware mirror placement; prev_racks
    # keeps the outgoing geometry for handoff (mirrors of the old view)
    racks: Dict[str, str] = field(default_factory=dict)
    prev_racks: Dict[str, str] = field(default_factory=dict)

    @property
    def world(self) -> int:
        return len(self.members)

    def rank_of(self, wid: str) -> Optional[int]:
        try:
            return self.members.index(wid)
        except ValueError:
            return None

    def holders(self) -> Tuple[str, ...]:
        """Members carrying live training state across this view change:
        survivors of the previous view whose process never restarted. A
        relaunched same-id worker is in ``members`` (and maybe in
        ``prev_members``) but its incarnation changed — it takes the
        handoff, it does not serve it."""
        return tuple(m for m in self.members
                     if m in self.prev_members
                     and self.incs.get(m) == self.prev_incs.get(m))

    def to_json(self) -> dict:
        return {
            "gen": self.gen, "members": list(self.members),
            "prev_members": list(self.prev_members), "epoch": self.epoch,
            "step": self.step, "iteration": self.iteration,
            "reason": self.reason, "rejoined": list(self.rejoined),
            "incs": dict(self.incs), "prev_incs": dict(self.prev_incs),
            "racks": dict(self.racks), "prev_racks": dict(self.prev_racks),
        }

    @staticmethod
    def from_json(d: dict) -> "View":
        return View(
            gen=int(d["gen"]), members=tuple(d["members"]),
            prev_members=tuple(d.get("prev_members", ())),
            epoch=int(d.get("epoch", 0)), step=int(d.get("step", 0)),
            iteration=int(d.get("iteration", 0)),
            reason=str(d.get("reason", "")),
            rejoined=tuple(d.get("rejoined", ())),
            incs=dict(d.get("incs", {})),
            prev_incs=dict(d.get("prev_incs", {})),
            racks=dict(d.get("racks", {})),
            prev_racks=dict(d.get("prev_racks", {})))


class MembershipChanged(Exception):
    """Control-flow signal: a newer view exists (shrink, grow, or this
    worker's own expulsion). The trainer catches it at/above the step
    boundary and re-forms at ``self.view``."""

    def __init__(self, view: View):
        super().__init__(f"membership changed: gen {view.gen} "
                         f"({view.reason}; world {view.world})")
        self.view = view


def _view_key(gen: int) -> str:
    return f"view/{gen:08d}"


class ElasticRuntime:
    """Membership + view agreement for one worker of an elastic group."""

    def __init__(self, store: FileStore, wid: str, *,
                 ttl: Optional[float] = None, poll: Optional[float] = None,
                 rack: Optional[str] = None):
        knobs = elastic_knobs()
        self.store = store
        self.wid = wid
        self.ttl = float(knobs["ttl_s"] if ttl is None else ttl)
        self.poll = float(knobs["poll_s"] if poll is None else poll)
        self.wait_timeout = float(knobs["wait_timeout_s"])
        self.rack = str(os.environ.get("DL4J_TPU_RACK", "")
                        if rack is None else rack)
        self.membership = Membership(store, wid, ttl=self.ttl,
                                     poll=self.poll, rack=self.rack)
        self.view: Optional[View] = None

    # -- store-side view helpers -------------------------------------------
    def latest_view(self) -> Optional[View]:
        names = self.store.list("view")
        for name in reversed(names):
            d = self.store.get_json(f"view/{name}")
            if d is not None:
                return View.from_json(d)
        return None

    def _seen_key(self, wid: str) -> str:
        return f"seen/{wid}"

    def _lease_inc(self, wid: str) -> Optional[str]:
        lease = self.membership.lease(wid)
        return None if lease is None else str(lease.get("inc", ""))

    def _lease_rack(self, wid: str) -> str:
        lease = self.membership.lease(wid)
        return "" if lease is None else str(lease.get("rack", ""))

    def member_alive(self, wid: str) -> bool:
        """Alive AS THE MEMBER the adopted view admitted: fresh lease AND
        unchanged incarnation. A relaunched process under the same id has a
        fresh lease but a new incarnation — its training state is gone, so
        for membership purposes the member is dead (and the fresh lease is
        a joiner)."""
        lease = self.membership.lease(wid)
        if not self.membership._fresh(lease):
            return False
        want = (self.view.incs.get(wid)
                if self.view is not None else None)
        return want is None or str(lease.get("inc", "")) == want

    def _propose(self, members: Sequence[str], prev: Sequence[str],
                 sync: Tuple[int, int, int], reason: str) -> View:
        """Propose the next generation; return whatever view actually wins
        that generation (ours or a concurrent coordinator's)."""
        base = self.view.gen if self.view is not None else -1
        latest = self.latest_view()
        if latest is not None:
            base = max(base, latest.gen)
        gen = base + 1
        added = [m for m in members if m not in prev]
        rejoined = tuple(m for m in added
                         if self.store.exists(self._seen_key(m)))
        incs = {m: (self._lease_inc(m) or "") for m in members}
        racks = {m: self._lease_rack(m) for m in members}
        carry = (self.view is not None
                 and tuple(sorted(prev)) == self.view.members)
        prev_incs = dict(self.view.incs) if carry else {}
        prev_racks = dict(self.view.racks) if carry else {}
        cand = View(gen=gen, members=tuple(sorted(members)),
                    prev_members=tuple(sorted(prev)), epoch=sync[0],
                    step=sync[1], iteration=sync[2], reason=reason,
                    rejoined=rejoined, incs=incs, prev_incs=prev_incs,
                    racks=racks, prev_racks=prev_racks)
        if self.store.set_json_exclusive(_view_key(gen), cand.to_json()):
            return cand
        d = self.store.get_json(_view_key(gen))
        return View.from_json(d) if d else cand

    # -- adoption (metrics + events live here) ------------------------------
    def adopt(self, view: View) -> View:
        removed = sorted(set(view.prev_members) - set(view.members))
        added = sorted(set(view.members) - set(view.prev_members))
        rank = view.rank_of(self.wid)
        obs.gauge("dl4j_workers_active",
                  "Live workers in the adopted membership view").set(
                      view.world)
        if removed:
            obs.counter("dl4j_elastic_shrink_total",
                        "Workers expelled across adopted views").inc(
                            len(removed))
        if view.rejoined:
            obs.counter("dl4j_elastic_rejoin_total",
                        "Previously-seen workers re-admitted across adopted "
                        "views").inc(len(view.rejoined))
        obs.event("membership_change", gen=view.gen,
                  members=list(view.members), removed=removed, added=added,
                  rejoined=list(view.rejoined), reason=view.reason,
                  epoch=view.epoch, step=view.step,
                  iteration=view.iteration, rank=rank, wid=self.wid,
                  lease_ttl_s=self.ttl)
        if rank is not None:
            # membership history marker: a future re-admission of this wid
            # is a REJOIN, not a first join (counted separately above)
            self.store.set(self._seen_key(self.wid), b"1")
            # fleet identity: every span/event this process records from
            # here on carries its rank/incarnation, so the collector and
            # the merged trace can tell the workers apart
            obs.set_process_context(rank=rank, wid=self.wid,
                                    incarnation=self.membership.incarnation)
        self.view = view
        return view

    # -- bootstrap ----------------------------------------------------------
    def bootstrap(self, world: int,
                  timeout: Optional[float] = None) -> View:
        """Join and agree on an initial view.

        Three ways in: (a) fresh group — wait for ``world`` live leases, the
        lowest wid proposes generation 0; (b) rejoin — a run is in progress
        (live holders of the latest view exist), wait for them to grow the
        view around us; (c) restart — views exist but no holder is alive
        (full-group preemption), the lowest live wid proposes a
        ``restart`` view with no state holders, and every worker restores
        from the distributed checkpoint.
        """
        knobs = elastic_knobs()
        timeout = knobs["boot_timeout_s"] if timeout is None else timeout
        self.membership.join()
        deadline = time.monotonic() + timeout
        token = self.store.watch("", None)
        while True:
            latest = self.latest_view()
            if (latest is not None and self.wid in latest.members
                    and latest.incs.get(self.wid)
                    == self.membership.incarnation):
                return self.adopt(latest)
            live = self.membership.live()
            if latest is None:
                if len(live) >= world and live and live[0] == self.wid:
                    view = self._propose(live, (), (0, 0, 0), "bootstrap")
                    return self.adopt(view)
            else:
                holders = [m for m in latest.members
                           if m != self.wid and m in live
                           and latest.incs.get(m) == self._lease_inc(m)]
                if not holders:
                    # no live state holder: full-group restart from durable
                    # checkpoints (the proposer carries no training state,
                    # which is fine — nobody's is live)
                    if live and live[0] == self.wid:
                        view = self._propose(
                            live, (), (latest.epoch, latest.step,
                                       latest.iteration), "restart")
                        return self.adopt(view)
                # else: run in progress — the survivors' coordinator grows
                # the view around our fresh lease at their next boundary
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic bootstrap: worker {self.wid!r} saw "
                    f"{len(live)}/{world} live workers and no adoptable "
                    f"view within {timeout:.0f}s")
            # wake on any store change (lease writes, view creates) or after
            # one poll interval — lease EXPIRY makes no store event, so the
            # timeout bound is what notices silent deaths
            token = self.store.watch("", token, timeout=self.poll)

    # -- steady-state polling -----------------------------------------------
    def newer_view(self) -> Optional[View]:
        latest = self.latest_view()
        if latest is not None and (self.view is None
                                   or latest.gen > self.view.gen):
            return latest
        return None

    def check_for_change(self) -> None:
        """Raise :class:`MembershipChanged` when the store has moved past
        our adopted view (cheap; called inside payload waits)."""
        nv = self.newer_view()
        if nv is not None:
            raise MembershipChanged(nv)

    def poll_boundary(self, sync: Tuple[int, int, int]) -> None:
        """Step-boundary membership poll — the ONLY place grows happen, so a
        mid-step join never tears a step in half. Raises
        :class:`MembershipChanged` when a newer view exists or this call
        proposes one (lease lost → shrink, fresh lease → grow/rejoin)."""
        self.check_for_change()
        view = self.view
        live = self.membership.live()
        dead = [m for m in view.members if not self.member_alive(m)]
        joiners = [w for w in live if w not in view.members or w in dead]
        if not dead and not joiners:
            return
        holders = [m for m in view.members if m not in dead]
        if not holders:
            return  # we lost our own lease too; expulsion surfaces elsewhere
        if holders[0] != self.wid:
            # not the coordinator: the change is real, but only the
            # coordinator proposes; we either see its view next poll or
            # propose ourselves once its lease expires
            return
        members = holders + joiners
        reason = ("reform" if (dead and joiners)
                  else "shrink" if dead else "grow")
        nv = self._propose(members, view.members, sync, reason)
        raise MembershipChanged(nv)

    def report_dead(self, wids: Sequence[str],
                    sync: Tuple[int, int, int]) -> None:
        """A payload wait proved ``wids`` unrecoverable mid-step (lease
        expired AND no mirror can serve). Drive a shrink: coordinator
        proposes, everyone else waits for the winning view. Always raises
        :class:`MembershipChanged` (or times out)."""
        view = self.view
        deadline = time.monotonic() + self.wait_timeout
        token = self.store.watch("", None)
        while True:
            self.check_for_change()
            live = self.membership.live()
            holders = [m for m in view.members
                       if m not in wids and self.member_alive(m)]
            if holders and holders[0] == self.wid:
                joiners = [w for w in live
                           if w not in holders and w not in wids]
                nv = self._propose(holders + joiners, view.members, sync,
                                   "shrink")
                raise MembershipChanged(nv)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic shrink: no coordinator produced a view "
                    f"excluding {list(wids)} within "
                    f"{self.wait_timeout:.0f}s")
            token = self.store.watch("view", token, timeout=self.poll)

    def await_readmission(self, should_stop=None) -> Optional[View]:
        """Expelled-worker path (partition healed past the TTL): renew the
        lease and wait for the survivors to grow a view that includes us.
        ``should_stop`` (optional callable) lets the caller abort the wait —
        e.g. when the job finished while we were on the wrong side of the
        partition and nobody is left to re-admit us; returns None then."""
        self.membership.heartbeat_now()
        obs.event("elastic_rejoin_wait", wid=self.wid,
                  gen=self.view.gen if self.view else -1)
        deadline = time.monotonic() + self.wait_timeout
        token = self.store.watch("view", None)
        while True:
            latest = self.latest_view()
            if (latest is not None and self.wid in latest.members
                    and latest.incs.get(self.wid)
                    == self.membership.incarnation
                    and (self.view is None or latest.gen > self.view.gen)):
                return latest
            if should_stop is not None and should_stop():
                obs.event("elastic_rejoin_abandoned", wid=self.wid)
                return None
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic rejoin: worker {self.wid!r} was not "
                    f"re-admitted within {self.wait_timeout:.0f}s")
            # new views are store writes, so the watch wakes promptly; the
            # timeout keeps should_stop responsive
            token = self.store.watch("view", token,
                                     timeout=max(self.poll, 0.05))

    # -- teardown -----------------------------------------------------------
    def leave(self) -> None:
        self.membership.leave()
