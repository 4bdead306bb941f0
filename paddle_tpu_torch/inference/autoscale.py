"""SLO-driven autoscaling and preemption tolerance for the serving fleet.

Counterpart of paddle_tpu/inference/autoscale.py (the port keeps its own
copy). Two controllers, composable:

- **Autoscaler**: a host-side control loop over `EngineRouter`
  (inference/router.py). Each `tick()` reads one occupancy signal,
  (router-queued + in-flight demand) / (dispatchable replicas x slots),
  and, when given, a profiler/slo.py BurnRateMonitor's short-window burn
  rate, and drives `spawn_replica` / `drain_replica` with hysteresis
  (separate scale-out and scale-in thresholds), streaks (`breach_ticks`,
  `idle_ticks`), a cooldown between actions and `min_replicas` /
  `max_replicas` bounds, all on an injectable clock. Scale-in is
  graceful: the drained replica migrates its live requests out (zero
  re-prefill) and the router releases it at its first empty tick.

- **EnginePreemptGuard**: the lease detection of parallel/elastic.py
  (`DeviceLeases`) over one tensor-parallel ServingEngine's mesh, one
  lease a rank. Every rank of the mesh runs its own guard beside its
  engine and polls it after each tick; `testing/faults.py`
  ``replica_preempt@T:R`` wedges the last R leases through this
  module's `_FAULT_HOOK` (each rank's plan fires alike, so every rank
  reaches the same decision at the same poll). On staleness the guard
  degrades tp through `plan_serving_tp`, builds the survivors' mesh (a
  collective over the world: the leaving ranks build it too) and calls
  `ServingEngine.rebuild_on_mesh` on every rank: the survivors' live
  streams continue in place, a leaving rank's engine retires.

Observables: serving.autoscale.{scale_out,scale_in,preemptions}
counters, the serving.autoscale.replicas_target and occupancy gauges
(the router adds migrations / migrate_fallbacks /
migrated_pages_bytes), a flight dump on every scale or preempt decision.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..profiler import monitor

__all__ = ["AutoscaleConfig", "Autoscaler", "EnginePreemptGuard"]

# testing/faults.py installs a callable here: consulted once an
# EnginePreemptGuard.poll as _FAULT_HOOK(tick) -> dict, e.g.
# {"replica_preempt": n_ranks} (wedge the LAST n leases of the mesh;
# detection still runs the real staleness rule). None in production.
_FAULT_HOOK = None


@dataclasses.dataclass
class AutoscaleConfig:
    """Control-loop knobs. Occupancy is demand/capacity: (router
    pending + per-replica in-flight) / (dispatchable replicas x
    num_slots) — >= 1.0 means requests are queueing somewhere."""
    min_replicas: int = 1
    max_replicas: int = 4
    scale_out_occupancy: float = 0.95    # breach at/above this...
    scale_in_occupancy: float = 0.25     # ...idle at/below this
    breach_ticks: int = 3                # consecutive breaches -> out
    idle_ticks: int = 8                  # consecutive idles -> in
    cooldown_s: float = 5.0              # min wall gap between actions
    burn_threshold: float = 1.0          # SLO short-window burn -> breach

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        if self.scale_in_occupancy >= self.scale_out_occupancy:
            raise ValueError(
                "hysteresis requires scale_in_occupancy "
                f"({self.scale_in_occupancy}) < scale_out_occupancy "
                f"({self.scale_out_occupancy})")


class Autoscaler:
    """SLO/occupancy-driven replica-count controller over an
    EngineRouter.

    >>> scaler = Autoscaler(router, spawn=make_engine)
    >>> while router.has_work():
    ...     router.step()
    ...     scaler.tick()

    `spawn` is a zero-arg factory returning a warm ServingEngine
    sharing the fleet's params/config (create_router's engine
    construction is the template). The scaler never blocks a tick:
    spawn cost (engine construction, the first dispatches' graph
    captures) is paid once a scale-out, and in the steady state `tick()`
    is pure host arithmetic."""

    def __init__(self, router, spawn: Callable[[], object],
                 cfg: Optional[AutoscaleConfig] = None,
                 slo=None, clock=None):
        self.router = router
        self.spawn = spawn
        self.cfg = cfg or AutoscaleConfig()
        self.slo = slo                  # profiler.slo.BurnRateMonitor
        # default to the ROUTER's clock so one injected clock drives
        # deadlines and autoscale cooldowns coherently
        self._clock = (clock if clock is not None
                       else getattr(router, "_clock", time.perf_counter))
        self._breach = 0                # consecutive breach ticks
        self._idle = 0                  # consecutive idle ticks
        self._last_action = -float("inf")
        self._m_out = monitor.counter("serving.autoscale.scale_out")
        self._m_in = monitor.counter("serving.autoscale.scale_in")
        self._m_target = monitor.gauge(
            "serving.autoscale.replicas_target")
        self._m_occ = monitor.gauge("serving.autoscale.occupancy")
        from ..profiler import flight_recorder
        self._flight = flight_recorder.recorder()
        self._m_target.set(len(router.dispatchable()))

    # ----------------------------------------------------------- signals
    def occupancy(self, role: str = None) -> float:
        """Demand over capacity across the dispatchable fleet; +inf
        when demand exists but nothing admits (all draining/dead) —
        the strongest possible scale-out signal. With a `role`
        ("prefill" | "decode") the signal narrows to that capability
        pool: router-queued requests are demand on the PREFILL pool
        (they are waiting to be prefilled), in-flight load counts
        against whichever pool holds it."""
        reps = self.router.dispatchable()
        if role == "prefill":
            reps = [r for r in reps if r.can_prefill]
        elif role == "decode":
            reps = [r for r in reps if r.can_decode]
        demand = sum(r.load() for r in reps)
        if role != "decode":
            demand += len(self.router._pending)
        cap = sum(r.eng.num_slots for r in reps)
        if cap == 0:
            return float("inf") if demand else 0.0
        return demand / cap

    def burn(self) -> float:
        """Max short-window burn rate across the SLO monitor's
        objectives (0.0 without a monitor — occupancy alone then
        drives the loop)."""
        if self.slo is None:
            return 0.0
        short = min(s for _, s in self.slo.pairs)
        now = self._clock()
        return max((self.slo.burn_rate(o.name, short, now=now)
                    for o in self.slo.objectives), default=0.0)

    # -------------------------------------------------------- the tick
    def tick(self) -> Optional[str]:
        """One control decision. Returns "scale_out" / "scale_in" when
        an action fired, else None. Call once per router step.

        Over a role-split fleet (any replica with role != "any") the
        loop is PER-POOL: scale-out targets the breaching capability
        pool (a prefill flood spawns a prefill replica and leaves the
        decode pool alone — the disaggregation isolation property),
        the spawned replica inherits that role (the `spawn` factory
        may accept a `role=` kwarg; a factory without one still
        works), and scale-in never drains the last replica of a
        capability."""
        cfg = self.cfg
        role_aware = any(r.role != "any" for r in self.router.replicas)
        if role_aware:
            occ_by = {"prefill": self.occupancy("prefill"),
                      "decode": self.occupancy("decode")}
            occ = max(occ_by.values())
        else:
            occ = self.occupancy()
        self._m_occ.set(0.0 if occ == float("inf") else occ)
        breach = (occ >= cfg.scale_out_occupancy
                  or self.burn() >= cfg.burn_threshold)
        idle = (not breach) and occ <= cfg.scale_in_occupancy
        # streaks: the dead band between the thresholds resets BOTH —
        # a noisy signal oscillating inside the band never acts
        self._breach = self._breach + 1 if breach else 0
        self._idle = self._idle + 1 if idle else 0
        now = self._clock()
        if now - self._last_action < cfg.cooldown_s:
            return None
        n = len(self.router.dispatchable())
        if self._breach >= cfg.breach_ticks and n < cfg.max_replicas:
            role = ("any" if not role_aware
                    else max(occ_by, key=occ_by.get))
            idx = self.router.spawn_replica(self._spawn(role), role=role)
            self._after_action(now, occ, n + 1)
            self._m_out.add()
            self._flight.note(autoscale_scale_out=idx, role=role,
                              occupancy=round(min(occ, 1e9), 3),
                              replicas=n + 1)
            self._flight.dump("autoscale_scale_out")
            return "scale_out"
        if self._idle >= cfg.idle_ticks and n > cfg.min_replicas:
            # drain the least-loaded dispatchable replica — its live
            # requests migrate out, the router releases it when empty.
            # Role-split: a replica whose drain would zero out a
            # capability pool is not a candidate
            cands = self.router.dispatchable()
            if role_aware:
                cands = [r for r in cands
                         if not self._last_of_capability(r)]
                if not cands:
                    return None
            victim = min(cands, key=lambda r: (r.load(), -r.idx))
            self.router.drain_replica(victim.idx, migrate=True)
            self._after_action(now, occ, n - 1)
            self._m_in.add()
            self._flight.note(autoscale_scale_in=victim.idx,
                              occupancy=round(occ, 3), replicas=n - 1)
            self._flight.dump("autoscale_scale_in")
            return "scale_in"
        return None

    def _spawn(self, role: str):
        """Call the user's spawn factory, forwarding the target role
        when the factory takes one (a role-oblivious factory — the
        pre-disaggregation signature — still works: every engine is
        role-capable, the role only steers the ROUTER's placement)."""
        if role != "any":
            import inspect
            try:
                params = inspect.signature(self.spawn).parameters
                takes_role = ("role" in params
                              or any(p.kind is p.VAR_KEYWORD
                                     for p in params.values()))
            except (TypeError, ValueError):   # builtins/C callables
                takes_role = False
            if takes_role:
                return self.spawn(role=role)
        return self.spawn()

    def _last_of_capability(self, rep) -> bool:
        """True when draining `rep` would leave the dispatchable set
        without prefill or without decode capability."""
        rest = [r for r in self.router.dispatchable() if r is not rep]
        return (not any(r.can_prefill for r in rest)
                or not any(r.can_decode for r in rest))

    def _after_action(self, now: float, occ: float, target: int) -> None:
        self._last_action = now
        self._breach = 0
        self._idle = 0
        self._m_target.set(target)


class EnginePreemptGuard:
    """Lease/watchdog preemption detection for ONE tp-sharded
    ServingEngine, one lease a rank of its mesh: `poll()` after each
    engine tick on every rank; a stale lease degrades tp through the
    planner and rebuilds the engine on the surviving ranks with its live
    streams migrated in place.

    >>> guard = EnginePreemptGuard(engine)
    >>> while engine.has_work():
    ...     engine.step()
    ...     guard.poll()

    In production the pulse is fed by per-host heartbeats; in drills
    `testing/faults.py` ``replica_preempt@T:R`` wedges R leases through
    this module's `_FAULT_HOOK`, backdated, so the real staleness rule
    fires at the next poll (the elastic-training detection discipline,
    parallel/elastic.py)."""

    def __init__(self, engine, lease_timeout_s: float = 5.0,
                 chip=None):
        if engine.mesh is None:
            raise ValueError("EnginePreemptGuard needs a tp-sharded "
                             "engine (mesh=)")
        from ..parallel.elastic import DeviceLeases
        self.engine = engine
        self.lease_timeout_s = float(lease_timeout_s)
        self.chip = chip
        # the mesh's ranks stand for the reference's devices
        self._devices = [int(r) for r in engine.mesh.mesh.flatten()]
        self.leases = DeviceLeases([str(d) for d in self._devices])
        self._ticks = 0
        self._m_preempt = monitor.counter(
            "serving.autoscale.preemptions")
        from ..profiler import flight_recorder
        self._flight = flight_recorder.recorder()

    def poll(self) -> int:
        """Pulse live leases, detect staleness, degrade and rebuild when
        ranks are gone. Returns the NEW tp degree after a rebuild (on
        every rank, a leaving one included), else 0 (no action)."""
        if _FAULT_HOOK is not None:
            actions = _FAULT_HOOK(self._ticks) or {}
            lose = actions.pop("replica_preempt", None)
            if lose:
                keys = [str(d) for d in self._devices]
                self.leases.wedge(keys[-int(lose):])
        self._ticks += 1
        self.leases.pulse()
        stale = set(self.leases.stale(self.lease_timeout_s))
        if not stale:
            return 0
        from ..parallel.mesh import build_mesh
        survivors = [d for d in self._devices if str(d) not in stale]
        if not survivors:
            raise RuntimeError("every rank's lease stale — no mesh left "
                               "to rebuild the engine on")
        from ..parallel.planner import plan_serving_tp
        plan = plan_serving_tp(self.engine.cfg, len(survivors),
                               num_slots=self.engine.num_slots,
                               max_len=self.engine.max_len,
                               chip=self.chip)
        tp = plan["tp"]
        mesh = build_mesh({"tp": tp}, devices=survivors[:tp],
                          device_type=self.engine.mesh.device_type)
        migrated = self.engine.rebuild_on_mesh(mesh)
        self._devices = survivors[:tp]
        self.leases.reset([str(d) for d in self._devices])
        self._m_preempt.add()
        self._flight.note(serving_preempt_lost=sorted(stale),
                          new_tp=tp, migrated=migrated,
                          tick=self._ticks)
        self._flight.dump("serving_preempt")
        return tp
