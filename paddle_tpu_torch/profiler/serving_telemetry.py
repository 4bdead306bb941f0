"""In-tick serving telemetry: per-tick fields computed on the device that
ride the tick's one token pull.

Counterpart of paddle_tpu/profiler/serving_telemetry.py (`TICK_FIELDS`
:69, `resolve_serving_telemetry` :76, `pack_tick_fields` :102,
`ServingTelemetry` :115), copied but for `pack_tick_fields`, which
stacks torch tensors.

The serving tick already pays exactly one host pull (the sampled tokens,
inference/serving.py `_pull`), so the cheapest telemetry piggybacks on
it: the tick computes a small int32 row (tokens emitted, active slots,
poisoned rows, cache tokens attended, spec proposed/accepted) with a few
masked reductions on the device, and the engine packs it into the same
int32 tensor as the tokens, so the one `.cpu()` fetches both. Under a
CUDA graph (multi_tick=K) the row is an output of the captured graph:
no extra pull, no extra capture, no extra replay.

Host-side, each tick's row joins the scheduler's own knowledge (queue
depth, mid-prefill slot count, pages in use) and the tick's wall time
into one `serving_tick` record, kept in a bounded ring and optionally
streamed to a JSONL file through the training pipeline's background
writer (profiler/telemetry.TelemetryWriter). Prefill device calls get
`serving_prefill` records. tools/telemetry_report.py summarizes the
stream of either package.

JSONL schema (the reference's):
  {"kind": "serving_run",     "t", "pid", "fields", ...meta}
  {"kind": "serving_tick",    "tick", "t", "dur_ms", <field>: int, ...,
                              "queue_depth", "prefilling", "pages_in_use"}
  {"kind": "serving_prefill", "tick", "t", "dur_ms", "chunk_len",
                              "bucket", "final", "slot"}

Kill switch: PADDLE_TPU_SERVING_TELEMETRY; off values disable the fields
for new engines even when built with telemetry="on". Default on.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Optional

__all__ = ["ENV_SERVING_TELEMETRY", "TICK_FIELDS",
           "resolve_serving_telemetry", "pack_tick_fields",
           "ServingTelemetry"]

ENV_SERVING_TELEMETRY = "PADDLE_TPU_SERVING_TELEMETRY"

# device-computed per-tick fields, in row order (int32):
#   tokens        tokens this tick emitted (poisoned rows excluded)
#   active        slots the tick advanced
#   poisoned      rows the quarantine flagged this tick
#   attended      cache tokens the tick's attention admitted
#                 (kernels/decode_attention.attended_tokens)
#   spec_proposed drafts proposed this tick (greedy slots x gamma)
#   spec_accepted drafts the verify pass kept
TICK_FIELDS = ("tokens", "active", "poisoned", "attended",
               "spec_proposed", "spec_accepted")

_OFF_VALUES = frozenset({"0", "off", "false", "no"})
_ON_VALUES = frozenset({"1", "on", "true", "yes"})


def resolve_serving_telemetry(knob: str = "auto") -> bool:
    """Engine-build resolution of the telemetry knob ('auto' | 'on' |
    'off') against the env kill switch, which wins only in the off
    direction: an env off value disables even knob='on', an env on value
    never overrides an explicit knob='off'. Unrecognized env values warn
    and defer to the knob."""
    env = os.environ.get(ENV_SERVING_TELEMETRY, "").strip().lower()
    if env and env in _OFF_VALUES:
        return False
    if env and env not in _ON_VALUES:
        import sys
        print(f"[serving_telemetry] {ENV_SERVING_TELEMETRY}={env!r} is "
              f"not one of {sorted(_ON_VALUES)} / {sorted(_OFF_VALUES)}; "
              "ignoring", file=sys.stderr, flush=True)
    if knob == "off":
        return False
    if knob in ("auto", "on"):
        return True
    raise ValueError(f"telemetry {knob!r} (auto|on|off)")


def pack_tick_fields(**fields):
    """Stack the named scalar tensors into the TICK_FIELDS int32 row on
    their device (missing fields record 0; unknown names raise). Only
    device ops: safe inside a CUDA graph capture."""
    import torch
    unknown = set(fields) - set(TICK_FIELDS)
    if unknown:
        raise ValueError(f"unknown tick fields {sorted(unknown)}; "
                         f"declared fields are {TICK_FIELDS}")
    device = next(v.device for v in fields.values()
                  if isinstance(v, torch.Tensor))

    def one(v):
        if isinstance(v, torch.Tensor):
            return v.reshape(()).to(torch.int32)
        return torch.full((), int(v), dtype=torch.int32, device=device)
    return torch.stack([one(fields.get(f, 0)) for f in TICK_FIELDS])


class ServingTelemetry:
    """Host half of the in-tick pipeline: a bounded in-memory ring of
    per-tick records (`ServingEngine.tick_records()`) plus an optional
    JSONL stream drained by a background writer thread."""

    def __init__(self, path: Optional[str] = None, every: int = 32,
                 ring: int = 4096, meta: Optional[dict] = None):
        if every < 1:
            raise ValueError("every must be >= 1")
        self.path = path
        self.every = int(every)
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(ring), 1))
        self._pending: list = []
        self._writer = None
        if path:
            from .telemetry import TelemetryWriter
            self._writer = TelemetryWriter(path)
            header = {"kind": "serving_run", "t": time.time(),
                      "pid": os.getpid(), "fields": list(TICK_FIELDS)}
            if meta:
                header.update(meta)
            self._writer.put([header])

    # ------------------------------------------------------------ records
    def record_tick(self, tick: int, dev_row, host: dict,
                    dur_ms: float) -> None:
        """One decode dispatch: `dev_row` the pulled TICK_FIELDS int32
        row (None with the device fields off), `host` the scheduler's
        fields, `dur_ms` the dispatch's wall time (its pull included)."""
        rec = {"kind": "serving_tick", "tick": int(tick),
               "t": time.time(), "dur_ms": round(float(dur_ms), 3)}
        if dev_row is not None:
            for f, v in zip(TICK_FIELDS, dev_row):
                rec[f] = int(v)
        rec.update(host)
        self._push(rec)

    def record_prefill(self, tick: int, dur_ms: float, chunk_len: int,
                       bucket: int, final: bool, slot: int) -> None:
        self._push({"kind": "serving_prefill", "tick": int(tick),
                    "t": time.time(), "dur_ms": round(float(dur_ms), 3),
                    "chunk_len": int(chunk_len), "bucket": int(bucket),
                    "final": bool(final), "slot": int(slot)})

    def _push(self, rec: dict) -> None:
        self._ring.append(rec)
        if self._writer is not None:
            self._pending.append(rec)
            if len(self._pending) >= self.every:
                # the memory gauges ride the batch drain: host-side
                # allocator reads, no device synchronization
                from .mem_audit import publish_hbm_gauges
                publish_hbm_gauges()
                self._writer.put(self._pending)
                self._pending = []

    # ------------------------------------------------------------- access
    def records(self) -> list:
        """The in-memory ring (newest last)."""
        return list(self._ring)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Push any pending batch and block until it is on disk (no-op
        without a JSONL path)."""
        if self._writer is None:
            return
        if self._pending:
            self._writer.put(self._pending)
            self._pending = []
        self._writer.flush(timeout=timeout)

    def close(self) -> None:
        if self._writer is not None:
            self.flush(timeout=30)
            self._writer.close()
            self._writer = None
