"""SLO burn-rate monitoring for the serving engine's streams.

Counterpart of paddle_tpu/profiler/slo.py (`Objective` :57, `Alert` :76,
`BurnRateMonitor` :90), copied: pure host code over the port's own
monitor and flight recorder. Declared objectives over the serving SLO
streams (`ServingEngine.export_slo_jsonl` records, the finish-reason
counters), multi-window error-budget burn rates (the Google SRE
workbook's multiwindow, multi-burn-rate pattern), and alerts that bump
the monitor counters `slo.alerts` and `slo.alerts.<objective>` and leave
a flight-recorder dump (`slo_burn_alert`) of the window in which the
budget burned.

- `Objective` declares what "bad" means for one stream: kind="latency",
  a sample (ms) above `threshold_ms` (TTFT, inter-token samples);
  kind="event", request-level (bad, total) counts (poisoned, evicted or
  timed-out finishes over completed requests). `budget` is the allowed
  bad fraction.
- `BurnRateMonitor` keeps a timestamped sample log per objective and, for
  each (long, short) window pair, the burn rate bad_fraction / budget.
  An alert fires when both windows of a pair burn at >= `alert_burn` (the
  long window filters blips, the short one makes the burn current), with
  a per-(objective, pair) cooldown.

The clock is injectable (`clock=`), so tests replay histories; `check()`
is pull-based, called at any cadence (naturally beside
`export_slo_jsonl`).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import monitor

__all__ = ["Objective", "Alert", "BurnRateMonitor", "DEFAULT_PAIRS"]

# (long_s, short_s) window pairs — serving-scale defaults (a fleet
# with hours-long budgets would pass SRE-workbook-scale pairs like
# (3600, 300), (21600, 1800))
DEFAULT_PAIRS: Tuple[Tuple[float, float], ...] = ((300.0, 30.0),
                                                  (60.0, 5.0))


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declared SLO. `name` keys the monitor counters and the
    report rows; `stream` names the sample stream fed to it (e.g.
    "ttft", "itl", "errors", "requeues")."""
    name: str
    stream: str
    kind: str = "latency"            # latency | event
    threshold_ms: float = 0.0        # latency: samples above are bad
    budget: float = 0.01             # allowed bad fraction

    def __post_init__(self):
        if self.kind not in ("latency", "event"):
            raise ValueError(f"kind {self.kind!r} (latency|event)")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1]; "
                             f"got {self.budget}")


@dataclasses.dataclass(frozen=True)
class Alert:
    """One fired alert: the objective, the window pair that burned,
    and the burn rates that tripped it."""
    objective: str
    window_s: float
    short_window_s: float
    burn_rate: float
    short_burn_rate: float
    t: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class BurnRateMonitor:
    """Multi-window burn-rate evaluation over declared objectives.

    Consumers: the alerting path (check() -> flight dump); the fleet's
    autoscaler (inference/autoscale.py) and brownout ladder
    (inference/brownout.py) read the short-window `burn_rate` per
    objective as a scale-out and a degrade signal."""

    def __init__(self, objectives: Sequence[Objective],
                 pairs: Sequence[Tuple[float, float]] = DEFAULT_PAIRS,
                 alert_burn: float = 1.0,
                 cooldown_s: float = 60.0,
                 clock: Callable[[], float] = time.time,
                 max_samples: int = 65536):
        if not objectives:
            raise ValueError("BurnRateMonitor needs >= 1 objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        for long_s, short_s in pairs:
            if short_s >= long_s:
                raise ValueError(f"window pair ({long_s}, {short_s}): "
                                 "short must be < long")
        self.objectives = list(objectives)
        self.pairs = [(float(a), float(b)) for a, b in pairs]
        self.alert_burn = float(alert_burn)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        # per objective: deque of (t, bad_count, total_count) — latency
        # samples are (t, 0/1, 1), event feeds batch
        self._samples: Dict[str, collections.deque] = {
            o.name: collections.deque(maxlen=max_samples)
            for o in self.objectives}
        self._by_stream: Dict[str, List[Objective]] = {}
        for o in self.objectives:
            self._by_stream.setdefault(o.stream, []).append(o)
        self._last_alert: Dict[tuple, float] = {}
        self._m_alerts = monitor.counter("slo.alerts")
        self.alerts: List[Alert] = []        # full history, in order

    # ------------------------------------------------------------ feeding
    def observe_latency(self, stream: str, ms, t: Optional[float] = None
                        ) -> None:
        """One or many latency samples (ms) for `stream` ("ttft" /
        "itl" / any declared latency stream). Streams with no declared
        objective are ignored — feed unconditionally."""
        t = self.clock() if t is None else float(t)
        samples = [ms] if isinstance(ms, (int, float)) else list(ms)
        for obj in self._by_stream.get(stream, ()):
            if obj.kind != "latency":
                raise TypeError(f"objective {obj.name!r} is not a "
                                "latency objective")
            log = self._samples[obj.name]
            for v in samples:
                log.append((t, 1 if float(v) > obj.threshold_ms else 0,
                            1))

    def observe_events(self, stream: str, bad: int, total: int,
                       t: Optional[float] = None) -> None:
        """One batch of request-level events for an event objective:
        `bad` bad outcomes out of `total`."""
        t = self.clock() if t is None else float(t)
        for obj in self._by_stream.get(stream, ()):
            if obj.kind != "event":
                raise TypeError(f"objective {obj.name!r} is not an "
                                "event objective")
            self._samples[obj.name].append((t, int(bad), int(total)))

    def feed_slo_record(self, rec: dict) -> None:
        """Consume one `serving_slo` JSONL record
        (ServingEngine.export_slo_jsonl schema: raw ttft_ms / itl_ms
        sample lists, stamped `t`)."""
        t = rec.get("t")
        if rec.get("ttft_ms"):
            self.observe_latency("ttft", rec["ttft_ms"], t=t)
        if rec.get("itl_ms"):
            self.observe_latency("itl", rec["itl_ms"], t=t)

    # ----------------------------------------------------------- checking
    def burn_rate(self, objective: str, window_s: float,
                  now: Optional[float] = None) -> float:
        """bad_fraction / budget over the trailing window (0.0 with no
        samples — an idle service burns no budget)."""
        now = self.clock() if now is None else float(now)
        obj = next(o for o in self.objectives if o.name == objective)
        bad = total = 0
        for t, b, n in self._samples[objective]:
            if t >= now - window_s:
                bad += b
                total += n
        if total == 0:
            return 0.0
        return (bad / total) / obj.budget

    def burn_rates(self, now: Optional[float] = None) -> dict:
        """objective -> {window_s: burn} over every distinct window
        (window keys rounded for stable JSON rendering)."""
        windows = sorted({w for pair in self.pairs for w in pair})
        return {o.name: {round(w, 1): round(
                            self.burn_rate(o.name, w, now), 3)
                         for w in windows}
                for o in self.objectives}

    def check(self, now: Optional[float] = None,
              flight: bool = True) -> List[Alert]:
        """Evaluate every (objective, window pair); fire alerts (both
        windows burning >= alert_burn, outside the pair's cooldown).
        Each alert increments `slo.alerts` + `slo.alerts.<objective>`
        and — with `flight` — leaves a `slo_burn_alert` flight dump
        carrying the burn rates (no-op without $PADDLE_TPU_FLIGHT_DIR,
        like every flight call)."""
        now = self.clock() if now is None else float(now)
        fired: List[Alert] = []
        for obj in self.objectives:
            for long_s, short_s in self.pairs:
                key = (obj.name, long_s, short_s)
                last = self._last_alert.get(key)
                if last is not None and now - last < self.cooldown_s:
                    continue
                long_burn = self.burn_rate(obj.name, long_s, now)
                if long_burn < self.alert_burn:
                    continue
                short_burn = self.burn_rate(obj.name, short_s, now)
                if short_burn < self.alert_burn:
                    continue
                self._last_alert[key] = now
                fired.append(Alert(obj.name, long_s, short_s,
                                   round(long_burn, 3),
                                   round(short_burn, 3), now))
        for alert in fired:
            self._m_alerts.add()
            monitor.counter(f"slo.alerts.{alert.objective}").add()
            monitor.gauge(f"slo.burn_rate.{alert.objective}").set(
                alert.burn_rate)
        if fired and flight:
            from . import flight_recorder
            rec = flight_recorder.recorder()
            rec.note(slo_burn_alerts=[a.to_dict() for a in fired])
            rec.configure(last_slo_alert=fired[-1].to_dict())
            rec.dump("slo_burn_alert")
        self.alerts.extend(fired)
        return fired

    # ------------------------------------------------------------ summary
    def summary(self, now: Optional[float] = None) -> dict:
        """The report block telemetry_report's fleet mode renders:
        per-objective burn rates per window + the alert history."""
        return {"objectives": [dataclasses.asdict(o)
                               for o in self.objectives],
                "burn_rates": self.burn_rates(now),
                "alerts": [a.to_dict() for a in self.alerts]}
