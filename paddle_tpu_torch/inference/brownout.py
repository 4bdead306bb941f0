"""Brownout ladder: ordered, observable service degradation under a
sustained SLO breach, with level-by-level recovery.

Counterpart of paddle_tpu/inference/brownout.py (the port keeps its own
copy). Where the autoscaler (inference/autoscale.py) answers sustained
overload by adding capacity, this controller sheds work quality; both
run the same control-loop guards: breach and clear streaks, a wall
cooldown between transitions, an injectable clock. It reads a
profiler/slo.py BurnRateMonitor.

The ladder (each level includes the ones below it):

    level  name                  action (enter)               undo (exit)
    -----  --------------------  ---------------------------  -----------
    0      normal                -                            -
    1      no_spec_drafts        disable speculative drafts   re-enable
           (greedy streams are the same either way, so
           nothing user-visible changes but capacity frees)
    2      suspend_low_priority  suspend the lowest priority  resume
           class's mid-decode streams to host KV (zero
           re-prefill on resume) and hold resumption
    3      shed_oldest           shed the oldest router-queued
           requests, `shed_per_tick` a tick (terminal
           "evicted", never limbo)

`breach_ticks` consecutive ticks with any objective's short-window burn
rate >= `burn_threshold` step one level up; `recover_ticks` consecutive
clear ticks step one level down; `cooldown_s` of the clock separates
transitions.

Observables: the serving.brownout_level gauge, the
serving.brownout.{escalations,recoveries,shed} counters, a flight dump
a transition (brownout_escalate / brownout_recover).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from ..profiler import monitor

__all__ = ["BrownoutConfig", "BrownoutController", "BROWNOUT_LEVELS"]

BROWNOUT_LEVELS = ("normal", "no_spec_drafts", "suspend_low_priority",
                   "shed_oldest")


@dataclasses.dataclass
class BrownoutConfig:
    """Control-loop knobs (autoscale.AutoscaleConfig's discipline)."""
    burn_threshold: float = 1.0     # short-window burn >= this = breach
    breach_ticks: int = 3           # consecutive breaches -> step up
    recover_ticks: int = 8          # consecutive clears -> step down
    cooldown_s: float = 5.0         # min wall gap between transitions
    shed_per_tick: int = 2          # level-3 shedding rate
    max_level: int = 3              # ladder ceiling (<= len(LEVELS)-1)

    def __post_init__(self):
        if not 0 <= self.max_level < len(BROWNOUT_LEVELS):
            raise ValueError(
                f"max_level must be in 0..{len(BROWNOUT_LEVELS) - 1}; "
                f"got {self.max_level}")
        if self.breach_ticks < 1 or self.recover_ticks < 1:
            raise ValueError("breach_ticks and recover_ticks must be "
                             ">= 1")
        if self.shed_per_tick < 1:
            raise ValueError(f"shed_per_tick must be >= 1; "
                             f"got {self.shed_per_tick}")


class BrownoutController:
    """SLO-burn-driven degrade controller over an EngineRouter.

    >>> ctrl = BrownoutController(router, slo=burn_monitor)
    >>> while router.has_work():
    ...     router.step()
    ...     ctrl.tick()

    `slo` is a profiler.slo.BurnRateMonitor (the caller feeds it
    latency samples); without one the controller never escalates —
    brownout is an SLO response, not a load response (the autoscaler
    owns occupancy)."""

    def __init__(self, router, slo=None,
                 cfg: Optional[BrownoutConfig] = None, clock=None):
        self.router = router
        self.slo = slo
        self.cfg = cfg or BrownoutConfig()
        self._clock = (clock if clock is not None
                       else getattr(router, "_clock", time.perf_counter))
        self.level = 0
        self._breach = 0
        self._clear = 0
        self._last_action = -float("inf")
        self._m_level = monitor.gauge("serving.brownout_level")
        self._m_esc = monitor.counter("serving.brownout.escalations")
        self._m_rec = monitor.counter("serving.brownout.recoveries")
        self._m_shed = monitor.counter("serving.brownout.shed")
        from ..profiler import flight_recorder
        self._flight = flight_recorder.recorder()
        self._m_level.set(0)

    # ----------------------------------------------------------- signal
    def burn(self) -> float:
        """Max short-window burn rate across the monitor's objectives
        (0.0 without a monitor)."""
        if self.slo is None:
            return 0.0
        short = min(s for _, s in self.slo.pairs)
        now = self._clock()
        return max((self.slo.burn_rate(o.name, short, now=now)
                    for o in self.slo.objectives), default=0.0)

    # ------------------------------------------------------------- tick
    def tick(self) -> Optional[str]:
        """One control decision after a router step. Returns
        "escalate" / "recover" when the level moved, else None. While
        AT level >= 3, sheds `shed_per_tick` oldest queued requests
        every tick regardless of transitions."""
        cfg = self.cfg
        burn = self.burn()
        breach = burn >= cfg.burn_threshold
        self._breach = self._breach + 1 if breach else 0
        self._clear = self._clear + 1 if not breach else 0
        moved = None
        now = self._clock()
        if now - self._last_action >= cfg.cooldown_s:
            if (breach and self._breach >= cfg.breach_ticks
                    and self.level < cfg.max_level):
                self._apply(self.level + 1, burn, now)
                moved = "escalate"
            elif (not breach and self._clear >= cfg.recover_ticks
                    and self.level > 0):
                self._apply(self.level - 1, burn, now)
                moved = "recover"
        if self.level >= 3:
            shed = self.router.shed_oldest_pending(cfg.shed_per_tick)
            if shed:
                self._m_shed.add(shed)
        return moved

    def _apply(self, new: int, burn: float, now: float) -> None:
        """Run the enter/exit actions between the current level and
        `new` (always one step with the default tick logic, but written
        transitional so a forced multi-level jump stays correct)."""
        old = self.level
        step = 1 if new > old else -1
        lvl = old
        while lvl != new:
            nxt = lvl + step
            if step > 0:
                self._enter(nxt)
            else:
                self._exit(lvl)
            lvl = nxt
        self.level = new
        self._breach = 0
        self._clear = 0
        self._last_action = now
        self._m_level.set(new)
        (self._m_esc if step > 0 else self._m_rec).add()
        self._flight.note(
            brownout_level=new, previous=old,
            name=BROWNOUT_LEVELS[new], burn=round(burn, 3),
            tick=getattr(self.router, "_ticks", -1))
        self._flight.dump("brownout_escalate" if step > 0
                          else "brownout_recover")

    def _enter(self, lvl: int) -> None:
        r = self.router
        if lvl == 1:
            r.set_spec_drafts(False)
        elif lvl == 2:
            r.set_resume_hold(True)       # suspended streams stay parked
            r.suspend_lowest_class()
        # lvl 3 needs no one-shot action: tick() sheds while AT it

    def _exit(self, lvl: int) -> None:
        r = self.router
        if lvl == 1:
            r.set_spec_drafts(True)       # no-op on spec-less engines
        elif lvl == 2:
            r.set_resume_hold(False)      # step() resumes as slots free
