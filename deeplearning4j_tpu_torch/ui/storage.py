"""Stats storage: the record store the UI reads from.

Reference surface: deeplearning4j-core api/storage/StatsStorage.java +
StatsStorageRouter.java (putUpdate/putStaticInfo, listSessionIDs,
getAllUpdatesAfter, listeners) and the ui/storage impls
(InMemoryStatsStorage, FileStatsStorage). Records here are plain dicts
with (session_id, type_id, worker_id, timestamp) keys; FileStatsStorage
appends JSON lines so a crashed run's stats survive.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional


class StatsStorage:
    """Router + query API (StatsStorageRouter / StatsStorage)."""

    def __init__(self):
        self._static: List[dict] = []
        self._updates: List[dict] = []
        self._listeners: List[Callable[[dict], None]] = []
        self._lock = threading.Lock()

    # -- router side -------------------------------------------------------
    def put_static_info(self, record: dict) -> None:
        record = dict(record, kind="static", timestamp=record.get("timestamp", time.time()))
        with self._lock:
            self._static.append(record)
        self._notify(record)

    def put_update(self, record: dict) -> None:
        record = dict(record, kind="update", timestamp=record.get("timestamp", time.time()))
        with self._lock:
            self._updates.append(record)
        self._notify(record)

    def _notify(self, record: dict) -> None:
        for cb in list(self._listeners):
            cb(record)

    def register_listener(self, cb: Callable[[dict], None]) -> None:
        self._listeners.append(cb)

    # -- query side --------------------------------------------------------
    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted({r["session_id"] for r in self._static + self._updates})

    def list_worker_ids(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted({
                r.get("worker_id", "0") for r in self._updates
                if r["session_id"] == session_id
            })

    def get_static_info(self, session_id: str) -> List[dict]:
        with self._lock:
            return [r for r in self._static if r["session_id"] == session_id]

    def get_all_updates(self, session_id: str) -> List[dict]:
        with self._lock:
            return [r for r in self._updates if r["session_id"] == session_id]

    def get_all_updates_after(self, session_id: str, timestamp: float) -> List[dict]:
        return [r for r in self.get_all_updates(session_id) if r["timestamp"] > timestamp]

    def get_latest_update(self, session_id: str) -> Optional[dict]:
        ups = self.get_all_updates(session_id)
        return ups[-1] if ups else None


InMemoryStatsStorage = StatsStorage


class FileStatsStorage(StatsStorage):
    """Durable JSON-lines storage (ui/storage FileStatsStorage capability):
    every record appends to ``path``; existing records load on open."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    r = json.loads(line)
                    (self._static if r.get("kind") == "static" else self._updates).append(r)
        self._file = open(path, "a")

    def _append(self, record: dict) -> None:
        self._file.write(json.dumps(record, default=float) + "\n")
        self._file.flush()

    def put_static_info(self, record: dict) -> None:
        record = dict(record, kind="static", timestamp=record.get("timestamp", time.time()))
        with self._lock:
            self._static.append(record)
            self._append(record)
        self._notify(record)

    def put_update(self, record: dict) -> None:
        record = dict(record, kind="update", timestamp=record.get("timestamp", time.time()))
        with self._lock:
            self._updates.append(record)
            self._append(record)
        self._notify(record)

    def close(self) -> None:
        self._file.close()


class RemoteStatsStorageRouter(StatsStorage):
    """Posts records to a remote UIServer's ``/remote`` endpoint
    (ui-model/.../impl/RemoteUIStatsStorageRouter.java capability): a
    training process streams stats into a dashboard served elsewhere.
    Implements the StatsStorage *write* surface; reads happen server-side.

    Fire-and-forget for real: ``put_*`` only appends to a bounded buffer;
    a daemon worker thread drains it over HTTP, so the training loop never
    waits on a socket (a blackholed UI host would otherwise stall every
    iteration for the full timeout). ``flush()`` blocks until the buffer
    drains — for shutdown or tests."""

    def __init__(self, url: str, timeout: float = 2.0, max_buffer: int = 4096):
        super().__init__()
        self.url = url.rstrip("/") + "/remote"
        self.timeout = timeout
        self.max_buffer = max_buffer
        self._pending: List[dict] = []
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._worker = threading.Thread(target=self._drain_loop, daemon=True)
        self._worker.start()

    @staticmethod
    def _coerce(o):
        """JSON fallback: numpy scalars/arrays and anything else become
        plain numbers/lists/strings — a stats record must never raise out
        of the training loop."""
        if hasattr(o, "tolist"):
            return o.tolist()
        try:
            return float(o)
        except (TypeError, ValueError):
            return str(o)

    def _post(self, records: List[dict]) -> bool:
        import urllib.error
        import urllib.request

        try:
            data = json.dumps(records, default=self._coerce).encode("utf-8")
        except (TypeError, ValueError):
            return True  # unserializable despite coercion: drop, don't
            # retry forever — re-posting can never succeed
        req = urllib.request.Request(
            self.url, data=data,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status == 200
        except urllib.error.HTTPError as e:
            # 4xx = the server REJECTED the batch (e.g. missing session_id):
            # retrying can never succeed — drop it like unserializable
            # records. 5xx/other statuses stay retryable.
            return 400 <= e.code < 500
        except Exception:
            # network errors AND protocol surprises (BadStatusLine,
            # IncompleteRead, ... are not OSError): the drain worker must
            # survive anything — telemetry never takes the process down
            return False

    def _drain_loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=1.0)
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._pending:
                        self._idle.set()
                        break
                    self._idle.clear()
                    batch, self._pending = self._pending, []
                if not self._post(batch):
                    with self._lock:
                        # keep for retry, bounded; back off until next wake
                        self._pending = (batch + self._pending)[-self.max_buffer:]
                    break

    def _send(self, record: dict) -> None:
        with self._lock:
            self._pending.append(record)
            del self._pending[:-self.max_buffer]
            self._idle.clear()
        self._wake.set()

    def put_static_info(self, record: dict) -> None:
        self._send(dict(record, _kind="static",
                        timestamp=record.get("timestamp", time.time())))

    def put_update(self, record: dict) -> None:
        self._send(dict(record, _kind="update",
                        timestamp=record.get("timestamp", time.time())))

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until the buffer drains (or timeout); True if drained.
        Deadline is monotonic — wall-clock jumps (NTP, DST) must not hang
        or cut short the wait."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._wake.set()
            if self._idle.wait(timeout=0.05) and self.pending_count() == 0:
                return True
        # _idle guard: an in-flight batch (buffer empty, worker mid-POST)
        # must not report as drained
        return self._idle.is_set() and self.pending_count() == 0

    def close(self) -> None:
        self._stop = True
        self._wake.set()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)
