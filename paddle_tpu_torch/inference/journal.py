"""Crash-safe request journal: an append-only WAL of admission and
terminal events, so a serving process killed mid-stream can restart and
replay every accepted but unresolved request.

Counterpart of paddle_tpu/inference/journal.py (the port keeps its own
copy). The on-disk format is the reference's byte for byte, so a WAL
written by either package recovers and replays in the other: one line an
event,

    <crc32:08x> <json>\n

where the CRC covers the json payload bytes and the json is compact
(separators "," and ":"). Two event kinds:

- ``admit``: the request's replay envelope (id, tenant, priority,
  prompt ids, max_new_tokens, temperature, top_k, eos_id), written after
  validation and the quota pass and fsynced before submit() returns, so
  "accepted" means "durable";
- ``end``: (id, finish_reason, tokens delivered), written by the
  router's exactly-once terminal seam (`EngineRouter._finish`). A quota
  or backpressure reject writes an ``end`` with no ``admit``; recovery
  ignores end-only ids (the rejection reached the caller as an
  exception and must not replay).

Recovery (at construction) reads the WAL front to back and stops at the
first record that fails its CRC or its JSON: a torn tail (the process
died mid-append) is tolerated, never fatal, and truncated away so later
appends land after the intact prefix. Every ``admit`` with no ``end`` is
returned by `replayable()`; the router re-submits them under the same
ids (at-least-once prefill, exactly-once terminal). Deadlines are not
journaled: a dead process's wall budgets mean nothing after a restart.

Observables: the serving.journal.appends / recovered / torn counters
(the router counts serving.journal.replays). Fault drill:
testing/faults.py ``journal_torn@N`` truncates N bytes off the WAL tail
through this module's `_FAULT_HOOK` before recovery reads it.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional

from ..profiler import monitor

__all__ = ["RequestJournal", "WAL_NAME"]

WAL_NAME = "requests.wal"

# testing/faults.py installs a callable here: consulted ONCE per
# recovery as _FAULT_HOOK() -> dict, e.g. {"journal_torn": nbytes}
# (truncate the WAL tail by nbytes before reading — the torn-tail
# drill). None in production.
_FAULT_HOOK = None


def _fsync_dir(path: str) -> None:
    # parallel/checkpoint.py:_fsync_dir — the rename/append becomes
    # durable only when the DIRECTORY entry is too
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class RequestJournal:
    """Append-only request WAL under `journal_dir` (one file,
    `requests.wal`). Single writer, on the thread of the router that owns
    it. Construction recovers: reads the existing WAL (tolerating a torn
    tail), indexes admits and ends, and reopens the file for append, so
    new records land after whatever survived."""

    def __init__(self, journal_dir: str, fsync: bool = True):
        self.dir = str(journal_dir)
        self.path = os.path.join(self.dir, WAL_NAME)
        self.fsync = bool(fsync)
        self.admits: Dict[int, dict] = {}
        self.ends: Dict[int, str] = {}
        self.torn_bytes = 0
        self._m_app = monitor.counter("serving.journal.appends")
        self._m_rec = monitor.counter("serving.journal.recovered")
        self._m_torn = monitor.counter("serving.journal.torn")
        os.makedirs(self.dir, exist_ok=True)
        self._recover()
        self._f = open(self.path, "ab")
        _fsync_dir(self.dir)

    # ---------------------------------------------------------- recovery
    def _recover(self) -> None:
        if _FAULT_HOOK is not None:
            actions = _FAULT_HOOK() or {}
            tear = int(actions.pop("journal_torn", 0) or 0)
            if tear > 0 and os.path.exists(self.path):
                size = os.path.getsize(self.path)
                os.truncate(self.path, max(size - tear, 0))
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        good = 0                       # bytes of intact prefix
        for line in data.split(b"\n"):
            if not line:
                good += 1              # the separator itself
                continue
            rec = self._parse(line)
            if rec is None:
                break                  # torn tail: stop, never raise
            good += len(line) + 1
            if rec["ev"] == "admit":
                self.admits[int(rec["id"])] = rec
            elif rec["ev"] == "end":
                self.ends[int(rec["id"])] = str(rec.get("reason", ""))
        good = min(good, len(data))
        if good < len(data):
            # the torn record's request never saw submit() return —
            # truncating to the intact prefix is correct AND keeps
            # later appends from landing mid-garbage
            self.torn_bytes = len(data) - good
            os.truncate(self.path, good)
            self._m_torn.add()
        if self.admits:
            self._m_rec.add(len(self.admits))

    @staticmethod
    def _parse(line: bytes) -> Optional[dict]:
        try:
            crc_hex, payload = line.split(b" ", 1)
            if int(crc_hex, 16) != (zlib.crc32(payload) & 0xFFFFFFFF):
                return None
            rec = json.loads(payload)
        except Exception:                          # noqa: BLE001
            return None
        return rec if isinstance(rec, dict) and "ev" in rec else None

    def replayable(self) -> List[dict]:
        """Admit records with no terminal event, id order — what the
        crashed process accepted but never resolved. End-only ids
        (rejections) never appear here by construction."""
        return [self.admits[i] for i in sorted(self.admits)
                if i not in self.ends]

    @property
    def next_id(self) -> int:
        """1 + the largest id the WAL has seen — the router seeds its
        id counter here so replayed and fresh requests never collide
        (the journal's terminal set stays keyed uniquely)."""
        ids = list(self.admits) + list(self.ends)
        return max(ids) + 1 if ids else 0

    # ------------------------------------------------------------ append
    def _append(self, rec: dict) -> None:
        payload = json.dumps(rec, separators=(",", ":")).encode()
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(b"%08x " % crc + payload + b"\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._m_app.add()

    def record_admit(self, req_id: int, prompt, max_new_tokens: int,
                     temperature: float, top_k: int, eos_id,
                     tenant: str, priority: int) -> None:
        """The durable-admission record — fsynced before submit()
        returns, so every request the caller believes accepted survives
        a SIGKILL."""
        self._append({"ev": "admit", "id": int(req_id),
                      "tenant": str(tenant), "priority": int(priority),
                      "prompt": [int(t) for t in prompt],
                      "max_new_tokens": int(max_new_tokens),
                      "temperature": float(temperature),
                      "top_k": int(top_k),
                      "eos_id": None if eos_id is None else int(eos_id)})
        # mirror the on-disk index so a SAME-PROCESS re-recover (tests)
        # and replayable() agree with what a restart would see
        self.admits[int(req_id)] = {
            "ev": "admit", "id": int(req_id), "tenant": str(tenant),
            "priority": int(priority),
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature), "top_k": int(top_k),
            "eos_id": None if eos_id is None else int(eos_id)}

    def record_terminal(self, req_id: int, reason: str,
                        tokens: int = 0) -> None:
        """The terminal record — written from the router's exactly-once
        `_finish`, so at most one per id per process; across a crash,
        recovery skips already-ended ids, keeping the terminal set
        duplicate-free."""
        self._append({"ev": "end", "id": int(req_id),
                      "reason": str(reason), "tokens": int(tokens)})
        self.ends[int(req_id)] = str(reason)

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:                          # noqa: BLE001
            pass
