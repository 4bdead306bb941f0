"""Exported runtime monitors: a thread-safe counter, gauge and histogram
registry.

Counterpart of paddle_tpu/profiler/monitor.py (`Counter` :38, `Gauge`
:64, `Histogram` :95, `MonitorRegistry` :181, the module helpers
:240-272), copied: the port imports nothing of the reference. One
registry holds three kinds, `Counter` (a monotonic int), `Gauge` (the
last float written) and `Histogram` (a bounded reservoir with exact
n/min/max/mean and reservoir percentiles), and `snapshot()` renders it
for the telemetry JSONL stream and the flight recorder: a histogram as
a small dict ({"n","min","max","mean","p50","p95","p99"}), every other
stat as a number, so tools/telemetry_report.py reads either package's
stream.

Design constraints, the reference's:
- import-light: it imports neither torch nor numpy, so the instrumented
  call sites (the launcher's controller among them) pay nothing to load
  it;
- thread-safe: the resilient trainer's watchdog thread, the telemetry
  writer thread, the checkpoint writer thread and user threads publish
  concurrently; one small lock a stat;
- cheap: call sites resolve a handle once and keep it, so the steady
  cost is a lock and an add.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Union


class Counter:
    """Monotonic integer stat (STAT_INT analog)."""

    kind = "counter"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def add(self, n: int = 1) -> int:
        with self._lock:
            self._value += int(n)
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written float stat (STAT_FLOAT analog)."""

    kind = "gauge"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> float:
        with self._lock:
            self._value = float(v)
            return self._value

    def add(self, v: float = 1.0) -> float:
        with self._lock:
            self._value += float(v)
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Latency/size distribution over a bounded reservoir.

    Reservoir sampling (Vitter's algorithm R) with a deterministic
    per-histogram PRNG: every observation is a candidate, the kept set
    is a uniform sample of everything ever observed, and memory is
    bounded at `reservoir` floats no matter how long the process
    serves. min/max/mean/count are tracked EXACTLY over all
    observations (they are not sampled); percentiles come from the
    reservoir. Determinism: the replacement stream is seeded from the
    stat name, so two runs observing the same sequence snapshot the
    same percentiles — test-assertable, like everything else in this
    registry."""

    kind = "histogram"
    DEFAULT_RESERVOIR = 2048
    __slots__ = ("name", "_lock", "_samples", "_cap", "_n", "_sum",
                 "_min", "_max", "_rng")

    def __init__(self, name: str, reservoir: int = DEFAULT_RESERVOIR):
        import random
        import zlib
        self.name = name
        self._lock = threading.Lock()
        self._cap = max(int(reservoir), 1)
        self._samples = []
        self._n = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._rng = random.Random(zlib.crc32(name.encode()))

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._n += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._samples) < self._cap:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self._n)
                if j < self._cap:
                    self._samples[j] = v

    def percentile(self, q: float):
        """Nearest-rank percentile over the reservoir (None when
        empty)."""
        with self._lock:
            ordered = sorted(self._samples)
        if not ordered:
            return None
        import math
        k = max(0, math.ceil(q / 100.0 * len(ordered)) - 1)
        return ordered[k]

    @property
    def value(self) -> dict:
        """The snapshot rendering: exact n/min/max/mean + reservoir
        percentiles, all rounded for stable JSONL output."""
        with self._lock:
            n, s = self._n, self._sum
            mn, mx = self._min, self._max
            ordered = sorted(self._samples)
        if not n:
            return {"n": 0}
        import math

        def pct(q):
            return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
        return {"n": n, "min": round(mn, 3), "max": round(mx, 3),
                "mean": round(s / n, 3), "p50": round(pct(50), 3),
                "p95": round(pct(95), 3), "p99": round(pct(99), 3)}

    def reset(self) -> None:
        with self._lock:
            self._samples = []
            self._n = 0
            self._sum = 0.0
            self._min = self._max = None


Stat = Union[Counter, Gauge, Histogram]


class MonitorRegistry:
    """The process-wide stat table (StatRegistry::Instance analog)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Stat] = {}

    def _get(self, name: str, cls) -> Stat:
        with self._lock:
            stat = self._stats.get(name)
            if stat is None:
                stat = cls(name)
                self._stats[name] = stat
            elif not isinstance(stat, cls):
                raise TypeError(
                    f"monitor stat {name!r} already registered as "
                    f"{stat.kind}, requested {cls.kind}")
            return stat

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str):
        with self._lock:
            return self._stats.get(name)

    def snapshot(self) -> Dict[str, Union[int, float]]:
        """name -> value for every registered stat, name-sorted (stable
        JSONL/flight-dump layout)."""
        with self._lock:
            stats = list(self._stats.values())
        return {s.name: s.value for s in sorted(stats, key=lambda s: s.name)}

    def reset(self) -> None:
        """Zero every stat (tests). Handles stay valid — call sites cache
        them."""
        with self._lock:
            stats = list(self._stats.values())
        for s in stats:
            s.reset()

    def export_jsonl(self, path: str) -> None:
        """Append one monitor-snapshot line to a telemetry JSONL file
        (the schema tools/telemetry_report.py consumes)."""
        line = json.dumps({"kind": "monitor", "t": time.time(),
                           "pid": os.getpid(), "stats": self.snapshot()})
        with open(path, "a") as f:
            f.write(line + "\n")


_REGISTRY = MonitorRegistry()


def registry() -> MonitorRegistry:
    """The process-wide registry singleton."""
    return _REGISTRY


def counter(name: str) -> Counter:
    """Get-or-create the named counter (resolve once, cache the handle
    at hot call sites)."""
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    """Get-or-create the named gauge."""
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    """Get-or-create the named histogram (bounded reservoir; snapshot
    renders p50/p95/p99)."""
    return _REGISTRY.histogram(name)


def snapshot() -> Dict[str, Union[int, float]]:
    return _REGISTRY.snapshot()


# reference-shaped conveniences (monitor.h STAT_ADD / STAT_SETTER)
def stat_add(name: str, n: int = 1) -> int:
    return _REGISTRY.counter(name).add(n)


def stat_set(name: str, v: float) -> float:
    return _REGISTRY.gauge(name).set(v)
