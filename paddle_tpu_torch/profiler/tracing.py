"""Request-scoped tracing for the serving engine: spans parented by
explicit ids, not by thread.

Counterpart of paddle_tpu/profiler/tracing.py (`Span` :54, `Tracer` :78,
`RequestTrace` :193, `tracer` :273, `clear` :283), copied: pure host
code, the port keeps its own. A serving request's lifecycle crosses the
scheduler's ticks, and (in a fleet) threads and engine instances, which
the thread-local depth stack of `profiler.RecordEvent` cannot follow;
the spans here carry (trace_id, span_id, parent_id) as any
OpenTelemetry-shaped tracer does.

- `Tracer`: the process-wide span log (thread-safe, bounded); engines
  share it, so a request's spans land in one timeline.
- `RequestTrace`: the context minted at `submit()` and carried on the
  Request through admission, prefill chunks, decode ticks and the
  terminal `_finish`. Spans open and close by id, instants record point
  events (each emitted token), and `finish()` emits the one terminal
  span, once only by construction.
- Replica death (inference/router.py): `sever()` closes every
  open span of the tree (tagged `severed`) without finishing it, and
  `link_replay()` records the replay link, so a replayed request shows
  attempt 0 cut short and attempt 1 carrying it to its terminal span.

`export_chrome_trace(path)` writes Perfetto / chrome://tracing JSON:
one tid lane a request, "X" events for spans, "i" for instants.
`profiler.RecordEvent`'s host span log is a separate timeline (the
engine's internals); this one is a request's.

Tracing is off by default (`ServingEngine(tracing=True)` opts in).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Tracer", "RequestTrace", "Span", "tracer", "clear"]


class Span:
    """One completed or open span. `dur` is None while open."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0",
                 "dur", "attrs", "kind")

    def __init__(self, trace_id, span_id, parent_id, name, t0,
                 kind="span", attrs=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.dur = None
        self.kind = kind                   # span | instant | terminal
        self.attrs = attrs or {}

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "t0": self.t0, "dur": self.dur, "kind": self.kind,
                "attrs": dict(self.attrs)}


class Tracer:
    """Process-global request-span log."""

    def __init__(self, max_spans: int = 65536):
        import collections
        self._lock = threading.Lock()
        self._spans: "collections.deque[Span]" = \
            collections.deque(maxlen=max_spans)
        self._open: Dict[int, Span] = {}     # span_id -> open span
        self._next_trace = 0
        self._next_span = 0

    # ------------------------------------------------------------ minting
    def trace(self, name: str, **attrs) -> "RequestTrace":
        """Mint a new trace: opens its root span and returns the
        context to thread through the request's lifecycle."""
        with self._lock:
            tid = self._next_trace
            self._next_trace += 1
        t = RequestTrace(self, tid, name)
        t.root = t.begin(name, parent=None, **attrs)
        return t

    def _begin(self, trace_id, name, parent_id, kind="span",
               **attrs) -> int:
        sp = Span(trace_id, 0, parent_id, name, time.perf_counter(),
                  kind=kind, attrs=attrs)
        with self._lock:
            sp.span_id = self._next_span
            self._next_span += 1
            if kind == "span":
                self._open[sp.span_id] = sp
            else:
                sp.dur = 0.0
                self._spans.append(sp)
        return sp.span_id

    def _end(self, span_id, **attrs) -> None:
        with self._lock:
            sp = self._open.pop(span_id, None)
            if sp is None:
                return                       # already closed (idempotent)
            sp.dur = time.perf_counter() - sp.t0
            if attrs:
                sp.attrs.update(attrs)
            self._spans.append(sp)

    def _open_of(self, trace_id) -> List[int]:
        with self._lock:
            return [sid for sid, sp in self._open.items()
                    if sp.trace_id == trace_id]

    # ------------------------------------------------------------- access
    def spans(self, trace_id: Optional[int] = None) -> List[Span]:
        """Completed spans (open ones are not included until ended)."""
        with self._lock:
            spans = list(self._spans)
        if trace_id is None:
            return spans
        return [s for s in spans if s.trace_id == trace_id]

    def trace_ids(self) -> List[int]:
        return sorted({s.trace_id for s in self.spans()})

    def terminal_spans(self, trace_id: Optional[int] = None) -> List[Span]:
        return [s for s in self.spans(trace_id) if s.kind == "terminal"]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open.clear()

    # ------------------------------------------------------------- export
    def export_chrome_trace(self, path: str) -> str:
        """Chrome-trace JSON: one tid lane per trace (request), "X"
        events for spans (args carry span/parent ids + attrs), "i"
        instants for point events. Atomic tmp+rename like
        profiler.export_chrome_trace."""
        pid = os.getpid()
        events = []
        lanes = {}
        for sp in self.spans():
            lane = lanes.setdefault(sp.trace_id, len(lanes))
            args = {"span_id": sp.span_id, "parent_id": sp.parent_id,
                    "trace_id": sp.trace_id}
            args.update({k: v for k, v in sp.attrs.items()
                         if isinstance(v, (int, float, str, bool,
                                           type(None)))})
            ev = {"name": sp.name, "pid": pid, "tid": lane,
                  "ts": round(sp.t0 * 1e6, 3), "cat": "request",
                  "args": args}
            if sp.kind == "span":
                ev["ph"] = "X"
                ev["dur"] = round((sp.dur or 0.0) * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
                if sp.kind == "terminal":
                    ev["cat"] = "terminal"
            events.append(ev)
        for trace_id, lane in lanes.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": lane,
                           "args": {"name": f"request-{trace_id}"}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"producer": "paddle_tpu_torch.profiler.tracing"}}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{pid}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


class RequestTrace:
    """The per-request context: explicit-parent span emission plus the
    once-only terminal transition. Thread-safe through the tracer's
    lock; the `finish` flag has its own tiny lock so the engine's and
    the router's `_finish` seams can race benignly."""

    __slots__ = ("_tracer", "trace_id", "name", "root", "_finished",
                 "_flock", "attempt")

    def __init__(self, tracer: Tracer, trace_id: int, name: str):
        self._tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self.root: Optional[int] = None
        self.attempt = 0                 # bumps on replica-death replay
        self._finished = False
        self._flock = threading.Lock()

    @property
    def finished(self) -> bool:
        return self._finished

    # -------------------------------------------------------------- spans
    def begin(self, name: str, parent: Optional[int] = "root",
              **attrs) -> int:
        """Open a span; `parent` defaults to the root span."""
        pid = self.root if parent == "root" else parent
        return self._tracer._begin(self.trace_id, name, pid, **attrs)

    def end(self, span_id: Optional[int], **attrs) -> None:
        if span_id is not None:
            self._tracer._end(span_id, **attrs)

    def instant(self, name: str, parent: Optional[int] = "root",
                **attrs) -> int:
        pid = self.root if parent == "root" else parent
        return self._tracer._begin(self.trace_id, name, pid,
                                   kind="instant", **attrs)

    # ---------------------------------------------------------- lifecycle
    def finish(self, reason: str, **attrs) -> bool:
        """THE terminal transition: close every open span of this trace
        (root included) and emit the one terminal event. Once-only —
        the engine's `_finish` and the router's `_finish` both call
        this; whichever lands first wins and the other is a no-op, so
        every request exports EXACTLY one terminal span. Returns True
        when this call emitted it."""
        with self._flock:
            if self._finished:
                return False
            self._finished = True
        self._tracer._begin(self.trace_id, "finish", self.root,
                            kind="terminal", reason=reason, **attrs)
        for sid in self._tracer._open_of(self.trace_id):
            self._tracer._end(sid, finish_reason=reason)
        return True

    def sever(self, reason: str, **attrs) -> None:
        """Replica death: close the trace's open span subtree (tagged
        severed) WITHOUT finishing — the request will replay. Records
        the death as an instant so the export shows the cut."""
        self.instant("severed", reason=reason, attempt=self.attempt,
                     **attrs)
        for sid in self._tracer._open_of(self.trace_id):
            self._tracer._end(sid, severed=True, severed_reason=reason)

    def link_replay(self, **attrs) -> int:
        """Record the replay link: bumps the attempt index and emits a
        "replay" instant parented at the root. The replaying engine
        does not need to know it is a replay — its spans parent at the
        root as usual, and the attempt counter in this instant is the
        link between the severed subtree and the fresh one."""
        self.attempt += 1
        return self.instant("replay", attempt=self.attempt, **attrs)


_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def tracer() -> Tracer:
    """The process-wide tracer singleton (engines and routers share
    it — a request's spans land in one timeline)."""
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is None:
            _TRACER = Tracer()
        return _TRACER


def clear() -> None:
    """Drop every recorded span (tests / chaos scenarios)."""
    tracer().clear()
