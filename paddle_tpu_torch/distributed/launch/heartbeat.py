"""Worker-side liveness heartbeat — the port's counterpart of
paddle_tpu/distributed/launch/heartbeat.py (host-only, no torch).

The lease is a file whose mtime a controller watches (the reference's
ElasticManager keeps an etcd lease per worker). `start_from_env()`
starts a beat thread when the controller exported the contract
(`PADDLE_HEARTBEAT_FILE`); under `PADDLE_HEARTBEAT_STEP_MODE=1` no
thread beats and only `pulse()`, which the resilient trainer calls per
committed step, refreshes the lease, so a hung step goes stale even
while the process lives. `stop()` stops beating.

The elastic exit code and the degraded-world handshake are the
reference's, name for name: a worker that exits with ELASTIC_EXIT_CODE
(101) asks for a restart that resumes from the checkpoint `LATEST`; one
that lost devices first writes a world spec (`write_world_spec`) that
the restarted worker reads back (`degraded_world`).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["ELASTIC_EXIT_CODE", "ENV_FILE", "ENV_INTERVAL", "ENV_STEP_MODE",
           "ENV_WORLD_FILE", "ENV_WORLD", "write_world_spec",
           "read_world_spec", "degraded_world", "start_from_env", "stop",
           "pulse"]

_thread: Optional[threading.Thread] = None
_stop = threading.Event()

ENV_FILE = "PADDLE_HEARTBEAT_FILE"
ENV_INTERVAL = "PADDLE_HEARTBEAT_INTERVAL"
# "1": no beat thread; only pulse() (one a committed step) touches the
# lease, so the controller's staleness clock tracks step progress
ENV_STEP_MODE = "PADDLE_HEARTBEAT_STEP_MODE"

# The elastic-protocol exit code (the reference's fleet/elastic
# manager.py:30): a restart-and-resume request, not a crash.
ELASTIC_EXIT_CODE = 101

# The degraded-world handshake riding the exit-101 protocol: spec keys
# (all optional) n_devices, cpu_devices, axes ({axis: degree}), reason.
ENV_WORLD_FILE = "PADDLE_TPU_ELASTIC_WORLD_FILE"
ENV_WORLD = "PADDLE_TPU_ELASTIC_WORLD"


def write_world_spec(spec: dict, path: Optional[str] = None
                     ) -> Optional[str]:
    """Atomically (tmp, fsync, rename) write the world spec a worker
    wants its elastic restart to come back with. Returns the path
    written, or None when no path is given and the launcher exported
    none."""
    path = path if path is not None else os.environ.get(ENV_WORLD_FILE)
    if not path:
        return None
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(spec))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_world_spec(path: str) -> Optional[dict]:
    """Parse a world-spec file (None when absent or unparseable: a torn
    spec degrades to the old-world restart)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def degraded_world() -> Optional[dict]:
    """The degraded world spec granted to this (restarted) worker through
    $PADDLE_TPU_ELASTIC_WORLD, or None on a full-world start."""
    raw = os.environ.get(ENV_WORLD)
    if not raw:
        return None
    try:
        doc = json.loads(raw)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def _touch(path: str) -> None:
    try:
        with open(path, "a"):
            os.utime(path, None)
    except OSError:
        pass


def start_from_env() -> bool:
    """Start the beat thread if the controller exported the contract;
    idempotent. Returns True when beating."""
    global _thread
    path = os.environ.get(ENV_FILE)
    if not path or (_thread is not None and _thread.is_alive()):
        return _thread is not None
    if os.environ.get(ENV_STEP_MODE) == "1":
        # the first touch covers boot; after that only pulse()
        _stop.clear()
        _touch(path)
        return True
    interval = float(os.environ.get(ENV_INTERVAL, "1.0"))
    _stop.clear()
    _touch(path)

    def beat():
        while not _stop.wait(interval):
            _touch(path)

    _thread = threading.Thread(target=beat, name="paddle-heartbeat",
                               daemon=True)
    _thread.start()
    return True


def stop() -> None:
    """Stop beating (the controller then sees this worker as hung)."""
    _stop.set()


_last_pulse = 0.0


def pulse() -> None:
    """Touch the lease now (one a committed step under the resilient
    trainer), and publish the gap since the previous pulse as the
    `heartbeat_staleness_s` monitor gauge (reference :157): how close the
    worker sails to the controller's --hang_timeout."""
    global _last_pulse
    now = time.time()
    if _last_pulse:
        from ...profiler import monitor
        monitor.gauge("heartbeat_staleness_s").set(now - _last_pulse)
    _last_pulse = now
    path = os.environ.get(ENV_FILE)
    if path and not _stop.is_set():
        _touch(path)
