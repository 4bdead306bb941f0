"""paddle_tpu_torch.profiler — spans, the profiler, the monitor, the flight
recorder and the device telemetry pipeline.

Counterpart of paddle_tpu/profiler/__init__.py (`ProfilerState` :39,
`make_scheduler` :54, the span log :84-112, `RecordEvent` :115,
`export_chrome_trace` :159, `export_chrome_tracing` :192, `Profiler`
:207, `get_profiler_spans` :332, `cost_analysis` :347) and of its
submodules `monitor`, `timer`, `flight_recorder`, `mem_audit` (three
functions), `telemetry`, and the serving engine's `serving_telemetry`
(the in-tick field row), `tracing` (request span trees) and `slo`
(burn-rate alerts).

Two recorders behind one API, as the reference's:
- Host spans: `RecordEvent` keeps a process-local span log (name, wall
  time, nesting depth, thread). `summary()` tabulates it,
  `export_chrome_trace(path)` writes it as a chrome-trace JSON, and the
  flight recorder carries its last 64 spans.
- The device trace: where the reference opens a
  `jax.profiler.TraceAnnotation`, a span here opens a
  `torch.profiler.record_function`, so it shows on the torch trace as a
  user annotation; `Profiler(trace_dir=...)` (or `on_trace_ready=
  export_chrome_tracing(dir)`) runs `torch.profiler.profile` over its
  RECORD steps, with CUDA activity where the card is there, and writes
  each recorded window's chrome trace into the directory beside the host
  spans.

`cost_analysis` (XLA's compiled cost model) has no counterpart in an
eager step; it waits for ROADMAP A7 part 4 and raises.
"""
from __future__ import annotations

import enum
import json
import os
import sys
import threading
import time
from typing import Callable, Iterable, Optional

from .timer import benchmark  # noqa: F401  (reference: profiler/timer.py)
from . import monitor  # noqa: F401  (reference: platform/monitor.h)


class ProfilerState(enum.Enum):
    """Scheduler states (reference :39)."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1          # the card: CUDA activity in the torch trace
    TPU = 2          # accepted for the reference's API; records nothing
    CUSTOM_DEVICE = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-indexed state machine: skip_first CLOSED steps, then cycles of
    [closed CLOSED, ready READY, record RECORD (the last
    RECORD_AND_RETURN)], `repeat` times (0 = forever)."""
    cycle = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat and step >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = step % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_scheduler(_step: int) -> ProfilerState:
    return ProfilerState.RECORD


# ------------------------------------------------------------- span recorder
class _SpanLog:
    """Process-local completed-span log."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.spans = []          # (name, start, dur_s, depth, tid)
        self.enabled = True

    def depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def push(self):
        self._tls.depth = self.depth() + 1

    def pop(self, name: str, start: float):
        d = self.depth() - 1
        self._tls.depth = d
        if self.enabled:
            with self._lock:
                self.spans.append((name, start, time.perf_counter() - start,
                                   d, threading.get_ident()))

    def clear(self):
        with self._lock:
            self.spans = []


_LOG = _SpanLog()


class RecordEvent:
    """Span context manager and decorator (reference :115). Records a host
    span and, where torch is loaded, a `torch.profiler.record_function`
    annotation, which a running torch profiler records and which costs a
    few microseconds otherwise. Never imports torch itself: the launcher's
    controller opens spans without loading it."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._start = None
        self._annot = None

    def begin(self):
        self._start = time.perf_counter()
        _LOG.push()
        torch = sys.modules.get("torch")
        if torch is not None:
            self._annot = torch.profiler.record_function(self.name)
            self._annot.__enter__()
        return self

    def end(self):
        if self._annot is not None:
            self._annot.__exit__(None, None, None)
            self._annot = None
        if self._start is not None:
            _LOG.pop(self.name, self._start)
            self._start = None

    __enter__ = begin

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)
        return wrapped


def _atomic_json(path: str, doc) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def export_chrome_trace(path: str, spans=None) -> str:
    """Write the completed host spans as a chrome-trace JSON file (complete
    "X" events, microsecond ts and dur, keyed by pid and tid), loadable in
    Perfetto or chrome://tracing. The torch trace of a `Profiler` window is
    a separate file beside it. Written to a temporary file and renamed;
    returns `path`."""
    spans = _LOG.spans if spans is None else spans
    pid = os.getpid()
    events = []
    for rec in list(spans):
        name, start, dur = rec[0], rec[1], rec[2]
        tid = rec[4] if len(rec) > 4 else 0
        events.append({
            "name": name, "ph": "X", "cat": "host",
            "ts": round(start * 1e6, 3), "dur": round(dur * 1e6, 3),
            "pid": pid, "tid": tid,
        })
    return _atomic_json(path, {
        "traceEvents": events, "displayTimeUnit": "ms",
        "otherData": {"producer": "paddle_tpu_torch.profiler"}})


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready factory: names the directory the Profiler writes its
    torch traces and host spans into."""

    def handler(prof: "Profiler"):
        prof._trace_dir = dir_name
    handler._trace_dir = dir_name
    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """The reference's alias of export_chrome_tracing (its trace is a
    protobuf dump); here the same chrome-trace files."""
    return export_chrome_tracing(dir_name, worker_name)


def _default_targets():
    torch = sys.modules.get("torch")
    cuda = torch is not None and torch.cuda.is_available()
    return [ProfilerTarget.CPU] + ([ProfilerTarget.GPU] if cuda else [])


class Profiler:
    """The reference-shaped profiler (reference :207) over
    torch.profiler.profile.

        with profiler.Profiler(scheduler=(2, 5), trace_dir=d) as p:
            for batch in loader:
                train_step(...)
                p.step()
        print(p.summary())

    With a trace directory (and not `timer_only`), each run of RECORD
    steps is one `torch.profiler.profile` window over the targets' CPU and
    CUDA activity (targets default to the CPU, and the card where CUDA is
    available), written on its end as `torch_trace.<pid>.<n>.json` in the
    directory (`trace_paths`; `last_profile` keeps the window's profile
    object for `key_averages()`); on `stop` the host spans go beside them
    as `host_trace.<pid>.json`."""

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready=None, timer_only: bool = False,
                 trace_dir: Optional[str] = None):
        if scheduler is None:
            self._schedule = _default_scheduler
        elif callable(scheduler):
            self._schedule = scheduler
        else:  # (start, end) step range, the reference's accepted form
            lo, hi = scheduler
            self._schedule = make_scheduler(closed=lo, ready=0, record=hi - lo,
                                            repeat=1)
        self.targets = list(targets) if targets else _default_targets()
        self._trace_dir = trace_dir
        if on_trace_ready is not None:
            td = getattr(on_trace_ready, "_trace_dir", None)
            if td:
                self._trace_dir = td
        self._on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._device_prof = None
        self.last_profile = None
        self.trace_paths = []
        self._step_times = []
        self._last_step_t = None

    # -------------------------------------------------------------- control
    def start(self):
        benchmark().begin()
        self.current_state = self._schedule(self.step_num)
        self._sync_device_trace()
        self._last_step_t = time.perf_counter()
        return self

    def stop(self):
        self._stop_device_trace()
        benchmark().end()
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)
        if self._trace_dir is not None and not self.timer_only:
            try:
                export_chrome_trace(os.path.join(
                    self._trace_dir, f"host_trace.{os.getpid()}.json"))
            except OSError:
                pass
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now
        benchmark().step(num_samples)
        self.step_num += 1
        prev = self.current_state
        self.current_state = self._schedule(self.step_num)
        if prev != self.current_state:
            self._sync_device_trace()

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if ProfilerTarget.GPU in self.targets:
            import torch
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
        return acts

    def _sync_device_trace(self):
        want = (self.current_state in (ProfilerState.RECORD,
                                       ProfilerState.RECORD_AND_RETURN)
                and self._trace_dir is not None and not self.timer_only)
        if want and self._device_prof is None:
            import torch.profiler
            self._device_prof = torch.profiler.profile(
                activities=self._activities())
            self._device_prof.__enter__()
        elif not want:
            self._stop_device_trace()

    def _stop_device_trace(self):
        prof, self._device_prof = self._device_prof, None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        self.last_profile = prof
        path = os.path.join(self._trace_dir, f"torch_trace.{os.getpid()}."
                            f"{len(self.trace_paths)}.json")
        os.makedirs(self._trace_dir, exist_ok=True)
        prof.export_chrome_trace(path)
        self.trace_paths.append(path)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------- reporting
    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms") -> str:
        """Host-span statistics and step-time statistics (the reference's
        profiler_statistic tables, host side)."""
        unit = {"s": 1.0, "ms": 1e3, "us": 1e6}.get(time_unit, 1e3)
        agg = {}
        for name, _start, dur, _depth, *_tid in _LOG.spans:
            c, tot, mx = agg.get(name, (0, 0.0, 0.0))
            agg[name] = (c + 1, tot + dur, max(mx, dur))
        lines = [f"{'name':<40} {'calls':>6} {'total':>10} {'avg':>10} "
                 f"{'max':>10}  ({time_unit})"]
        for name, (c, tot, mx) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<40} {c:>6} {tot * unit:>10.3f} "
                         f"{tot / c * unit:>10.3f} {mx * unit:>10.3f}")
        if self._step_times:
            st = sorted(self._step_times)
            n = len(st)
            lines.append("")
            lines.append(
                f"steps: {n}  avg {sum(st) / n * unit:.3f}{time_unit}  "
                f"p50 {st[n // 2] * unit:.3f}{time_unit}  "
                f"min {st[0] * unit:.3f}{time_unit}  "
                f"max {st[-1] * unit:.3f}{time_unit}")
        return "\n".join(lines)

    @property
    def step_times(self):
        return list(self._step_times)


def get_profiler_spans():
    """Raw completed host spans [(name, start, dur_s, depth, tid), ...]."""
    return list(_LOG.spans)


def clear_profiler_spans():
    _LOG.clear()


def load_profiler_result(filename: str):
    raise NotImplementedError(
        "the Profiler writes chrome-trace JSON files (Profiler.trace_paths); "
        "open them in Perfetto or chrome://tracing")


def cost_analysis(fn, *example_args, **kwargs):
    """The reference reads XLA's compiled cost model (flops, bytes,
    compiled memory) of a jitted callable; an eager torch step compiles
    nothing to ask. Its port waits for ROADMAP A7 part 4 (with the rest of
    mem_audit); the port's FLOP counts are cost_model.py's."""
    raise NotImplementedError(
        "profiler.cost_analysis: XLA's compiled cost model has no eager "
        "counterpart; it waits for ROADMAP A7 part 4 (use "
        "paddle_tpu_torch.cost_model.train_flops_per_token)")


def __getattr__(name):
    # telemetry imports torch; loading it on attribute access keeps
    # `import paddle_tpu_torch.profiler` light
    if name in ("telemetry", "flight_recorder", "mem_audit",
                "serving_telemetry", "tracing", "slo"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class SortedKeys(enum.Enum):
    """Summary-table sort keys (the reference's)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(enum.Enum):
    """Summary views (the reference's)."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8
