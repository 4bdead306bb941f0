"""The crash flight recorder: the black box of the fault-tolerant runtime.

Counterpart of paddle_tpu/profiler/flight_recorder.py (`FlightRecorder`
:43, `recorder` :174, `note` :184, `dump` :188, `load_dump` :192),
copied: a bounded ring of the last N host-side step records, the run
config, the monitor snapshot and the last 64 host spans, dumped as ONE
JSON file through a temporary file and a rename (readers never see a
torn file).

Dump triggers (wired in parallel/resilience.py, parallel/checkpoint.py,
parallel/elastic.py, models/facade.py and distributed/launch/main.py):
a watchdog hang, a rollback, an async checkpoint retry or failure, an
elastic device loss or degraded exit, an out-of-memory step, a launcher
whose restarts are spent, a process exit after records (atexit) or an
uncaught exception, and a cheap autodump every
$PADDLE_TPU_FLIGHT_AUTODUMP notes (default 1; no fsync: page-cache
contents survive a killed process).

The dump directory comes from $PADDLE_TPU_FLIGHT_DIR (the launcher
exports one for its workers); with none every call is a cheap no-op, so
the call sites stay instrumented unconditionally. A record holds host
values only: `note` refuses a torch tensor, whose conversion would
synchronize the card on every step.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from . import monitor

ENV_DIR = "PADDLE_TPU_FLIGHT_DIR"
ENV_N = "PADDLE_TPU_FLIGHT_N"            # ring size (default 64)
ENV_AUTODUMP = "PADDLE_TPU_FLIGHT_AUTODUMP"  # steps between autodumps (1)


class FlightRecorder:
    """Bounded ring of step records + context, atomically dumpable."""

    def __init__(self, dir: Optional[str] = None, n: Optional[int] = None,
                 autodump_every: Optional[int] = None):
        self._lock = threading.Lock()
        self.dir = dir if dir is not None else os.environ.get(ENV_DIR)
        n = n if n is not None else int(os.environ.get(ENV_N, "64"))
        self._ring: deque = deque(maxlen=max(int(n), 1))
        self.autodump_every = (autodump_every if autodump_every is not None
                               else int(os.environ.get(ENV_AUTODUMP, "1")))
        self.config: dict = {}
        self._notes = 0
        self._hooks_installed = False

    # ------------------------------------------------------------ recording
    def set_dir(self, dir: Optional[str]) -> None:
        self.dir = dir

    def configure(self, **run_config) -> None:
        """Merge run-level context (model/resilience config, world size,
        argv...) into the dump header."""
        with self._lock:
            self.config.update(run_config)

    def note(self, **record) -> None:
        """Append one step record (host-side scalars only — this runs
        after the step's own host pull, it must never force one: a torch
        tensor among the values raises TypeError)."""
        torch = sys.modules.get("torch")
        if torch is not None:
            bad = [k for k, v in record.items() if isinstance(v, torch.Tensor)]
            if bad:
                raise TypeError(f"flight recorder: {bad} are tensors; note "
                                f"host values (a tensor's conversion "
                                f"synchronizes its device)")
        record.setdefault("t", time.time())
        with self._lock:
            self._ring.append(record)
            self._notes += 1
            due = (self.dir and self.autodump_every > 0
                   and self._notes % self.autodump_every == 0)
        if due:
            self.dump("periodic", fsync=False)

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._notes = 0
            self.config = {}

    # -------------------------------------------------------------- dumping
    def _default_path(self, reason: str) -> Optional[str]:
        if not self.dir:
            return None
        # rolling reasons share one file; eventful triggers (rollback,
        # watchdog, exception...) get a reason-tagged file so later
        # periodic autodumps cannot overwrite the evidence
        if reason in ("periodic", "exit"):
            return os.path.join(self.dir, f"flight-{os.getpid()}.json")
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)
        return os.path.join(self.dir, f"flight-{os.getpid()}-{safe}.json")

    def dump(self, reason: str, path: Optional[str] = None,
             fsync: bool = True) -> Optional[str]:
        """Write the black box as one JSON file via tmp+rename (the
        checkpoint crash-safety idiom: readers never see a torn file).
        Returns the path, or None when no directory is configured."""
        path = path or self._default_path(reason)
        if path is None:
            return None
        with self._lock:
            doc = {
                "kind": "flight_recorder",
                "reason": reason,
                "t": time.time(),
                "pid": os.getpid(),
                "config": dict(self.config),
                "steps": list(self._ring),
                "monitor": monitor.snapshot(),
            }
        from .. import profiler as _prof
        doc["spans"] = [
            {"name": n, "start": s, "dur_s": d, "depth": depth}
            for (n, s, d, depth, *_t) in _prof.get_profiler_spans()[-64:]]
        try:
            text = json.dumps(doc)
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(text)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError) as e:
            # a full disk or an unserializable config value loses this
            # dump, visibly: counted, and reported on stderr
            monitor.counter("flight_dump_errors").add()
            print(f"[flight] dump failed: {e}", file=sys.stderr, flush=True)
            return None
        return path

    # ----------------------------------------------------------- exit hooks
    def install_exit_hooks(self) -> None:
        """Dump on process exit (atexit) and on uncaught exceptions.
        Idempotent; a no-op until a dump directory is configured —
        ResilientTrainer calls this unconditionally."""
        if self._hooks_installed:
            return
        self._hooks_installed = True
        import atexit

        def _on_exit():
            if self._ring and self.dir:
                self.dump("exit")
        atexit.register(_on_exit)

        prev = sys.excepthook

        def _on_exc(exc_type, exc, tb):
            try:
                self.configure(last_exception=f"{exc_type.__name__}: {exc}")
                if self.dir:
                    self.dump("exception")
            finally:
                prev(exc_type, exc, tb)
        sys.excepthook = _on_exc


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-wide recorder (created lazily so $PADDLE_TPU_FLIGHT_DIR
    set by the launcher's boot shim is read after it is exported)."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def note(**record) -> None:
    recorder().note(**record)


def dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    return recorder().dump(reason, path)


def load_dump(path: str) -> dict:
    """Parse a flight dump back (chaos-drill assertions / post-mortems)."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != "flight_recorder":
        raise ValueError(f"{path!r} is not a flight-recorder dump")
    return doc
