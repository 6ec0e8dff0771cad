"""CRC'd, toolchain-fingerprinted JSON tuning database (PyTorch port).

The JAX package's file format and entry key (``model_signature|backend``),
so either package reads the other's DB; an entry records the toolchain it
was measured under, and the other package's entries read as stale.

One zip file (written with the same ``_atomic_write_zip`` tmp/fsync/replace
discipline as checkpoints) holding a single ``tunedb.json`` entry plus a
``tunedb.json.crc32`` sidecar. Entries are keyed by
``model_signature|backend`` and each records the toolchain fingerprint it
was measured under (``nn.aot.toolchain_fingerprint``): at lookup time an
entry whose fingerprint no longer matches the running toolchain is treated
as STALE and ignored — PERF.md documented hand-set values flipping from
+12% to −12% across a toolchain bump, so a stale winner is worse than no
winner. A corrupt file (CRC mismatch, bad JSON, wrong format version) is
rejected whole, counted, and treated as empty; the DB is a cache, never
state.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.tune import knobs as _knobs

__all__ = ["TuningDB", "default_db_path", "DB_FORMAT_VERSION"]

DB_FORMAT_VERSION = 1
_JSON_ENTRY = "tunedb.json"
_CRC_ENTRY = "tunedb.json.crc32"

_rejected = obs.counter(
    "dl4j_tune_db_rejected_total",
    "tuning-DB loads rejected (corrupt file or CRC mismatch)")
_stale = obs.counter(
    "dl4j_tune_db_stale_total",
    "tuning-DB lookups discarded for toolchain-fingerprint mismatch")
_hits = obs.counter(
    "dl4j_tune_db_hits_total", "tuning-DB lookups that returned a winner")


def default_db_path() -> str:
    """``$DL4J_TPU_TUNE_DB`` or ``$DL4J_TPU_HOME/tune/tunedb.zip`` (same
    root convention as the pretrained-model cache)."""
    explicit = os.environ.get("DL4J_TPU_TUNE_DB")
    if explicit:
        return explicit
    root = os.environ.get("DL4J_TPU_HOME") or os.path.join(
        os.path.expanduser("~"), ".deeplearning4j_tpu")
    return os.path.join(root, "tune", "tunedb.zip")


def _entry_key(model_signature: str, backend: str) -> str:
    return f"{model_signature}|{backend}"


class TuningDB:
    def __init__(self, path: Optional[str] = None):
        self.path = os.fspath(path) if path is not None else default_db_path()

    # -- load / save -------------------------------------------------------

    def load(self) -> Dict[str, Any]:
        """Read and CRC-verify the DB. Any defect rejects the whole file
        (counted + event) and yields an empty DB — a tuner cache must never
        take the process down."""
        import zipfile

        if not os.path.exists(self.path):
            return {}
        try:
            with zipfile.ZipFile(self.path, "r") as zf:
                raw = zf.read(_JSON_ENTRY)
                want = int(zf.read(_CRC_ENTRY).decode("ascii").strip())
            got = zlib.crc32(raw) & 0xFFFFFFFF
            if got != want:
                raise ValueError(f"CRC mismatch: {got} != {want}")
            doc = json.loads(raw.decode("utf-8"))
            if doc.get("format_version") != DB_FORMAT_VERSION:
                raise ValueError(
                    f"format_version {doc.get('format_version')!r}")
            entries = doc.get("entries")
            if not isinstance(entries, dict):
                raise ValueError("entries missing")
            return entries
        except Exception as e:  # corrupt zip, bad json, crc, version...
            _rejected.inc()
            obs.event("tune_db_rejected", path=self.path, reason=str(e)[:200])
            return {}

    def save(self, entries: Dict[str, Any]) -> None:
        from deeplearning4j_tpu_torch.utils import serialization

        doc = {
            "format_version": DB_FORMAT_VERSION,
            "registry": _knobs.registry_dict(),
            "entries": entries,
        }
        raw = json.dumps(doc, sort_keys=True, indent=1).encode("utf-8")
        crc = str(zlib.crc32(raw) & 0xFFFFFFFF).encode("ascii")

        def write_entries(zf):
            zf.writestr(_JSON_ENTRY, raw)
            zf.writestr(_CRC_ENTRY, crc)

        os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".",
                    exist_ok=True)
        serialization._atomic_write_zip(self.path, write_entries)

    # -- record / lookup ---------------------------------------------------

    def record(self, model_signature: str, winner: Dict[str, Any],
               objective: Dict[str, Any], trials: int,
               toolchain: Optional[Dict[str, str]] = None,
               scope: str = "fit") -> Dict[str, Any]:
        """Persist the winning knob assignment for (signature, backend).
        ``winner`` maps knob *names* to typed values; unknown names are
        rejected so a DB can always be replayed through the registry."""
        from deeplearning4j_tpu_torch.nn import aot

        tc = toolchain or aot.toolchain_fingerprint()
        for name, value in winner.items():
            knob = _knobs.get(name)
            if knob is None:
                raise KeyError(f"unknown knob {name!r}")
            knob.validate(value)
        entry = {
            "model_signature": model_signature,
            "backend": tc["backend"],
            "toolchain": tc,
            "scope": scope,
            "knobs": dict(winner),
            "objective": dict(objective),
            "trials": int(trials),
        }
        entries = self.load()
        entries[_entry_key(model_signature, tc["backend"])] = entry
        self.save(entries)
        obs.event("tune_db_recorded", signature=model_signature[:12],
                  backend=tc["backend"], trials=trials,
                  knobs=json.dumps(winner, sort_keys=True))
        return entry

    def lookup(self, model_signature: str,
               toolchain: Optional[Dict[str, str]] = None,
               allow_stale: bool = False) -> Optional[Dict[str, Any]]:
        """Winner for (signature, current backend), or None. Re-validates
        the recorded toolchain fingerprint on every lookup — a match made
        under torch X on card Y says nothing about torch X' or card Y'."""
        from deeplearning4j_tpu_torch.nn import aot

        tc = toolchain or aot.toolchain_fingerprint()
        entry = self.load().get(_entry_key(model_signature, tc["backend"]))
        if entry is None:
            return None
        if entry.get("toolchain") != tc and not allow_stale:
            _stale.inc()
            obs.event("tune_db_stale", signature=model_signature[:12],
                      recorded=json.dumps(entry.get("toolchain"),
                                          sort_keys=True),
                      running=json.dumps(tc, sort_keys=True))
            return None
        _hits.inc()
        return entry
