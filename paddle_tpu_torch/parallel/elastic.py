"""Elastic training: device loss -> plan degrade -> reshard-restore ->
resume — the port's counterpart of paddle_tpu/parallel/elastic.py
(`_FAULT_HOOK`, `DeviceLossError` :96, `_Superseded` :107,
`ElasticConfig` :116, `DeviceLeases` :142, `request_degraded_restart`
:191, `ElasticTrainer` :214 with `train_step` :344, `_replan` :402 and
`_restore_onto` :468, `run_elastic` :526).

The reference drives every device from one process, so a lost device
is a name dropped from a list and the survivors' mesh is built in
place. Here one process drives one device: a lost device is a lost
rank, and the survivors are processes that must agree on what was lost
and meet again without it. So:

- **Leases live where every rank sees them.** `DeviceLeases` over a
  directory keeps one lease file a rank (its mtime the last pulse; each
  rank pulses its own after each committed step) and one marker file a
  wedged lease, backdated for good: the staleness check reads the same
  files on every rank. The injector (testing/faults.py `device_loss`)
  wedges leases; detection at a step boundary is always the staleness
  check. Every rank consults the same fault plan at the same
  boundaries, so every rank wedges the same leases and reaches the same
  verdict; a loss at the restore boundary is marked in each rank's own
  memory only, since a rank that ran ahead into the replan must not
  show it to one still at the step boundary. Organic staleness (a lease
  whose owner stopped pulsing) is agreed only as far as the ranks' lease
  clocks agree; the hang watchdog, which every rank of a wedged
  collective meets, is the trigger that holds across ranks. Without a
  directory (a world of one process) the leases live in memory, as the
  reference's do.
- **The survivors re-form on a fresh store.** `DeviceMesh` makes its
  groups with `new_group`, which every rank of the default group must
  enter, so a mesh over the survivors cannot be carved out of a world
  that still counts a dead rank. The controller takes the other way:
  each survivor the new plan keeps destroys its default group and
  joins a new one through a file store in the run directory, named by
  the run's token (agreed at construction) and the replan's generation,
  with ranks renumbered in survivor order; the new plan's mesh is built
  over it. A file store needs no surviving host (a TCP store dies with
  rank 0) and serves gloo and NCCL alike; a fresh name per generation
  means no rank ever meets a stale store. A rank keeps its first rank as
  its lease key (`rank<N>`) through every re-formation. What is drilled
  (tests/test_torch_elastic.py, chip_smoke.py 6d) is the re-formation on
  gloo after a lease loss and after an injected hang, which stalls the
  step before its collectives: no rank is inside a collective when its
  group is destroyed. A rank wedged inside a real gloo collective at
  that moment is not drilled.
- **Who leaves.** A rank whose own lease the replan dropped raises
  `ElasticDeparture(DECLARED_LOST_EXIT)` (103); a survivor the new plan
  leaves out (`survivors[new_plan.plan.n_devices:]`) raises
  `ElasticDeparture(LEFT_OUT_EXIT)` (102). Both are SystemExit: a
  worker that does not catch it exits with that code, which the launcher
  (distributed/launch/main.py) reads as a clean departure, not a crash.
- **Where the in-process route cannot hold, the controller raises and
  names it.** A world of several ranks needs a CheckpointManager: its
  root holds the run directory (`<root>/elastic`) of the leases and
  stores, and its snapshots are what the survivors restore (no rank
  holds the lost ranks' shards); a collective hang on the "nccl" route
  leaves a communicator wedged inside the abandoned dispatch, which no
  in-process re-formation can release. `restart_on_loss=True` (the
  exit-101 path through the launcher, which re-forms the world from
  scratch) runs there.

Detection layers, as the reference's:

- **lease staleness** at each step boundary;
- **the collective-hang watchdog**: the whole guarded step runs under a
  resilience.WatchdogPuller budget; an expired budget reads as device
  loss (the stale leases, or else the world's last `hang_shrink`
  ranks). ``collective_hang`` stalls inside the watched callable, so
  injected and organic hangs meet the same budget; ``straggler`` stalls
  within it and must not replan;
- **injectable mesh faults** at the "step" and "restore" boundaries.
  The restore boundary is consulted at the start of each re-degrade
  attempt, before the survivors re-form: every survivor, those the
  attempt would leave out included, must see a loss there to re-degrade
  together.

Replan protocol: settle the in-flight async save (every rank of the old
world, so a lost rank's writer still meets the others in the drill) ->
survivors = world minus stale leases -> `degrade_plan` (raises
NoFeasiblePlanError naming the violated constraint) -> the restore
boundary -> leavers leave, the rest re-form -> the new plan's mesh ->
reshard-restore of the newest intact snapshot (a trainer that has not
stepped yet holds the full trees and re-shards them instead) -> step
rebuild (the same `_ShardedTrainStep` re-pinned after a lease loss; a
FRESH trainer after a watchdog hang, because the abandoned watchdog
thread may still hold the old trainer, which is also detached from the
shared CheckpointManager, so a zombie step completing late cannot save
an abandoned-timeline checkpoint into the restored run) -> resume at
the restored step.

Observability, the reference's (:200, :281-289, :417-462): the
`train.elastic.*` monitor family (`replans`, `device_loss` and
`collective_hang` counters; `world_size`, `replan_ms` and
`reshard_bytes` gauges), an `elastic_device_loss` flight dump at each
loss (before a leaver departs), an `elastic_degraded_exit` dump before
the exit-101 route, and a replan note in the flight recorder's ring.
"""
from __future__ import annotations

import os
import sys
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .checkpoint import CheckpointManager, _flatten
from .planner import NoFeasiblePlanError, TrainPlan, degrade_plan, \
    plan_train
from .resilience import (ResilienceConfig, ResilientTrainer,
                         StepHungError, WatchdogPuller, plan_state_specs)
from ..distributed.launch.heartbeat import (ELASTIC_EXIT_CODE,
                                            degraded_world,
                                            write_world_spec)

__all__ = ["DeviceLossError", "ElasticConfig", "DeviceLeases",
           "ElasticTrainer", "ElasticDeparture", "run_elastic",
           "request_degraded_restart", "NoFeasiblePlanError",
           "LEFT_OUT_EXIT", "DECLARED_LOST_EXIT", "DEPARTURE_CODES"]

# Fault-injection seam (paddle_tpu_torch.testing.faults): called with
# (phase, step) at the elastic phase boundaries, phase "step" (before
# each step) or "restore" (at the start of each re-degrade attempt);
# returns an action dict: {"lose": K} wedges the last K leases of the
# world (detection then fires as staleness), {"stall_s": S} stalls the
# next watched step S seconds (inside the watchdog clock). Production
# code never sets it.
_FAULT_HOOK: Optional[Callable[[str, int], dict]] = None

# exit codes of a rank that leaves the world in-process: a survivor the
# degraded plan leaves out, and a rank whose own lease was declared lost
LEFT_OUT_EXIT = 102
DECLARED_LOST_EXIT = 103
DEPARTURE_CODES = (LEFT_OUT_EXIT, DECLARED_LOST_EXIT)

# seconds the survivors wait for each other on a re-formation's store
REFORM_TIMEOUT_S = 300.0


class DeviceLossError(RuntimeError):
    """Devices left the executing world. `lost` carries their lease
    keys."""

    def __init__(self, msg: str, lost: Optional[List[str]] = None):
        super().__init__(msg)
        self.lost = list(lost or [])


class _Superseded(RuntimeError):
    """An abandoned watchdog dispatch woke up after a replan superseded
    it; the zombie must not run a step against the orphaned trainer (its
    side effects, periodic saves at steps the restored run has not
    reached, would corrupt the trajectory)."""


class ElasticDeparture(SystemExit):
    """This rank leaves the world: `code` LEFT_OUT_EXIT (a survivor the
    degraded plan leaves out) or DECLARED_LOST_EXIT (its own lease was
    declared lost). Uncaught, the process exits with `code`."""

    def __init__(self, code: int, reason: str):
        super().__init__(code)
        self.reason = reason


@dataclass
class ElasticConfig:
    """Knobs of ElasticTrainer (detection and replan policy), the
    reference's."""
    heartbeat_timeout: float = 60.0   # lease staleness -> device lost
    step_timeout: float = 0.0         # collective-hang budget a step
    #                                   (0 = no step watchdog)
    warmup_factor: float = 20.0       # budget multiplier for a step
    #                                   whose pins are not derived yet
    #                                   (the first call after a build
    #                                   or replan)
    hang_retries: int = 0             # backoff retries before a hang
    #                                   is declared a loss
    hang_shrink: int = 1              # ranks to drop on a hang with no
    #                                   stale lease (the hung one is
    #                                   unidentifiable from here)
    max_replans: int = 4              # give up (raise) after this many
    restart_on_loss: bool = False     # write the degraded world spec and
    #                                   exit 101 for the launcher instead
    #                                   of replanning in-process


def _touch(path: str) -> None:
    with open(path, "a"):
        os.utime(path, None)


class DeviceLeases:
    """Liveness leases over the executing world, one a lease key.
    `pulse()` refreshes the leases this process holds; `wedge(keys)`
    marks leases dead, backdated, so `stale(timeout)` detects them at
    the very next boundary instead of waiting the timeout out (the
    injector simulates a dead device; the detector still runs the real
    staleness rule).

    In memory (`directory` None) the process holds every lease, as the
    reference's single controller does. Over a directory every rank
    sees every lease: `<key>.lease` (mtime: the owner's last pulse) and
    `<key>.wedged`; a process with `own` set pulses only its own lease,
    and a lease not yet written counts from `reset`."""

    def __init__(self, devices, directory: Optional[str] = None,
                 own: Optional[str] = None):
        self._dir = directory
        self._own = own
        self._t: Dict[str, float] = {}
        self._wedged: set = set()
        if directory:
            os.makedirs(directory, exist_ok=True)
        self.reset(devices)

    def _path(self, key: str, kind: str) -> str:
        return os.path.join(self._dir, f"{key}.{kind}")

    def _mine(self):
        return [self._own] if self._own in self._t else list(self._t)

    def reset(self, devices) -> None:
        now = time.monotonic()
        self._t = {str(k): now for k in devices}
        self._wedged = {k for k in self._wedged if k in self._t}
        self._reset_wall = time.time()
        if self._dir:
            for k in self._mine():
                if not self._is_wedged(k):
                    _touch(self._path(k, "lease"))

    def _is_wedged(self, key: str) -> bool:
        return key in self._wedged or bool(
            self._dir and os.path.exists(self._path(key, "wedged")))

    def pulse(self) -> None:
        now = time.monotonic()
        for k in self._mine():
            if self._is_wedged(k):
                continue
            if self._dir:
                _touch(self._path(k, "lease"))
            self._t[k] = now

    def wedge(self, keys, shared: bool = True) -> None:
        """Mark `keys` dead. `shared=False` keeps the mark in this
        process: every rank reaches it alike (a restore-boundary loss,
        which each rank draws from the same fault plan), and a rank
        running ahead must not show it to one still at an earlier
        boundary."""
        backdated = time.monotonic() - 1e9
        for k in keys:
            if k not in self._t:
                continue
            self._wedged.add(k)
            self._t[k] = backdated
            if self._dir and shared:
                _touch(self._path(k, "wedged"))

    def stale(self, timeout: float) -> List[str]:
        if timeout <= 0:
            return []
        if not self._dir:
            now = time.monotonic()
            return [k for k, t in self._t.items() if now - t > timeout]
        now = time.time()
        out = []
        for k in self._t:
            if self._is_wedged(k):
                out.append(k)
                continue
            try:
                last = os.stat(self._path(k, "lease")).st_mtime
            except OSError:
                last = self._reset_wall
            if now - max(last, self._reset_wall) > timeout:
                out.append(k)
        return out


def _tree_nbytes(tree) -> int:
    import torch
    return sum(leaf.numel() * leaf.element_size()
               for leaf in _flatten(tree).values()
               if isinstance(leaf, torch.Tensor))


def request_degraded_restart(spec: dict, reason: str = "device_loss"
                             ) -> None:
    """Device loss under a launcher: write the degraded world spec
    (heartbeat.write_world_spec) and exit with the elastic protocol code;
    the launcher relaunches that many ranks (distributed/launch/main.py
    re-exports the spec, `heartbeat.degraded_world()` hands it to the
    restarted workers), which resume from LATEST. The spec carries the
    wall time of the request (`t_exit`), so a restarted worker can time
    its relaunch. Dumps 'elastic_degraded_exit' first, so the exiting
    worker leaves a black box naming what it lost."""
    from ..profiler import flight_recorder
    rec = flight_recorder.recorder()
    rec.configure(elastic_world_spec=spec, elastic_reason=reason)
    rec.dump("elastic_degraded_exit")
    path = write_world_spec(dict(spec, reason=reason, t_exit=time.time()))
    print(f"[elastic] {reason}: requesting degraded restart "
          f"(world spec {spec}"
          + (f" -> {path}" if path else "; NO launcher world-file "
                                        "contract — old world restart")
          + f"); exiting {ELASTIC_EXIT_CODE}",
          file=sys.stderr, flush=True)
    sys.exit(ELASTIC_EXIT_CODE)


class ElasticTrainer:
    """Owns the world (ranks, plan, mesh) around a ResilientTrainer and
    survives device loss by replanning onto the survivors.

        plan = plan_train(cfg, world, global_batch, fsdp=world)
        et = ElasticTrainer(llama.train_step, params, opt, cfg=cfg,
                            global_batch=B, manager=mgr, plan=plan,
                            config=ElasticConfig(step_timeout=30),
                            resilience=ResilienceConfig(
                                checkpoint_every=1), lr=3e-4)
        et.maybe_resume()
        run_elastic(et, batch_fn, total_steps)

    Every rank of the world constructs it with FULL trees (the first
    step shards them) and calls each method alike. `train_step(batch)`
    returns `(loss, ok)`, or None when a replan rewound the run (the
    caller re-fetches the batch of the restored step; run_elastic
    does). A rank that leaves the world raises ElasticDeparture.

    The world is the default process group, which must hold exactly the
    plan's devices. A worker restarted by the launcher after an elastic
    exit honours the granted world spec: its plan's axes replace a
    given plan that wants more devices. `device_type` is the mesh's
    ("cpu" for gloo ranks on the host)."""

    def __init__(self, step_fn, params, opt_state, *, cfg, global_batch,
                 manager: Optional[CheckpointManager] = None,
                 plan: Optional[TrainPlan] = None, chip=None,
                 config: Optional[ElasticConfig] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 telemetry=None, param_specs=None,
                 device_type: str = "cuda", **step_kw):
        import torch.distributed as dist
        self.config = config or ElasticConfig()
        self._step_fn = step_fn
        self._cfg = cfg
        self._gb = int(global_batch)
        self._chip = chip
        self._param_specs = param_specs
        self._rcfg = resilience or ResilienceConfig()
        self._telemetry = telemetry
        self._step_kw = step_kw
        self._device_type = device_type
        self.manager = manager
        if not dist.is_initialized():
            from .env import init_parallel_env
            init_parallel_env(backend="gloo" if device_type == "cpu"
                              else None)
        n_world = dist.get_world_size()
        granted = degraded_world()
        self.granted = granted
        if granted and granted.get("n_devices"):
            n = int(granted["n_devices"])
            if plan is None or plan.plan.n_devices > n:
                axes = dict(granted.get("axes") or {})
                plan = plan_train(cfg, n, self._gb, chip=chip,
                                  param_specs=param_specs, **axes)
        if plan is None:
            plan = plan_train(cfg, n_world, self._gb, chip=chip,
                              param_specs=param_specs)
        if plan.plan.n_devices != n_world:
            raise ValueError(
                f"ElasticTrainer: plan {plan.name} needs "
                f"{plan.plan.n_devices} ranks, the world holds {n_world}; "
                "launch exactly the plan's ranks")
        self.plan = plan
        self._key = f"rank{dist.get_rank()}"
        self.world = [f"rank{r}" for r in range(n_world)]
        self._run_dir = self._resolve_run_dir()
        self._token = self._agree_token() if n_world > 1 else "solo"
        self.mesh = plan.build_mesh(device_type=device_type)
        self.leases = DeviceLeases(
            self.world,
            directory=(os.path.join(self._run_dir, f"leases.{self._token}")
                       if self._run_dir else None),
            own=self._key if self._run_dir else None)
        self.replans = 0
        # the step of the snapshot the last replan reshard-restored from
        # (None before any): a clean restore of ckpt-<last_restore_step>
        # on the degraded plan must reproduce the resumed trajectory bit
        # for bit
        self.last_restore_step: Optional[int] = None
        # the last replan's host seconds by phase (detect: the step
        # boundary or the hang to the verdict; settle: the in-flight
        # save; reform: the new group and mesh; restore: the snapshot
        # onto the new plan and the rebuild) and bytes restored
        self.last_replan: Dict[str, float] = {}
        self._gen = 0
        self._pending_stall = 0.0
        self._puller = WatchdogPuller(label="elastic-step")
        from ..profiler import flight_recorder, monitor
        self._mon_replans = monitor.counter("train.elastic.replans")
        self._mon_loss = monitor.counter("train.elastic.device_loss")
        self._mon_hang = monitor.counter("train.elastic.collective_hang")
        self._mon_world = monitor.gauge("train.elastic.world_size")
        self._mon_replan_ms = monitor.gauge("train.elastic.replan_ms")
        self._mon_reshard = monitor.gauge("train.elastic.reshard_bytes")
        self._mon_world.set(len(self.world))
        self._flight = flight_recorder.recorder()
        self._trainer = self._make_trainer(params, opt_state, step=0)

    def _resolve_run_dir(self) -> Optional[str]:
        """The manager's `<root>/elastic`, where every rank meets: the
        leases and the re-formation stores (None without a manager)."""
        if self.manager is None:
            return None
        d = os.path.join(self.manager.root, "elastic")
        os.makedirs(d, exist_ok=True)
        return d

    def _agree_token(self) -> str:
        """A name every rank of this run shares for its leases and
        stores, rank 0's, broadcast over the checkpoint coordination
        group: a relaunched run never meets an earlier run's files."""
        import torch.distributed as dist
        from .checkpoint import coord_group
        box = [uuid.uuid4().hex[:12] if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0, group=coord_group())
        return box[0]

    def _make_trainer(self, params, opt_state, step, mesh=None, plan=None,
                      shapes=None) -> ResilientTrainer:
        tr = ResilientTrainer(
            self._step_fn, params, opt_state, cfg=self._cfg,
            manager=self.manager, config=self._rcfg, step=step,
            mesh=mesh if mesh is not None else self.mesh,
            plan=plan if plan is not None else self.plan,
            telemetry=self._telemetry, **self._step_kw)
        if shapes is not None:
            # a fresh trainer on restored LOCAL shards: pin from the full
            # shapes the run started with
            tr._shapes = shapes
            tr._guarded.adopt_shapes(*shapes)
        return tr

    # ------------------------------------------------------- delegation
    @property
    def step(self) -> int:
        return self._trainer.step

    @property
    def params(self):
        return self._trainer.params

    @property
    def opt_state(self):
        return self._trainer.opt_state

    @property
    def trace_count(self) -> int:
        """The executing step's pin derivations (0 after a replan until
        its first step, then 1)."""
        return getattr(self._trainer._guarded, "trace_count", -1)

    def maybe_resume(self) -> bool:
        return self._trainer.maybe_resume()

    def save(self):
        return self._trainer.save()

    # -------------------------------------------------------- detection
    def _consult_faults(self, phase: str) -> dict:
        if _FAULT_HOOK is None:
            return {}
        return _FAULT_HOOK(phase, self.step) or {}

    def _apply_actions(self, act: dict, candidates) -> None:
        """Apply an injected action dict: lease wedging here (detection
        stays the staleness check); stalls park until the next watched
        step."""
        k = int(act.get("lose", 0))
        if k > 0:
            self.leases.wedge(list(candidates)[-k:])
        if act.get("stall_s"):
            self._pending_stall = float(act["stall_s"])

    # ------------------------------------------------------------- step
    def train_step(self, batch):
        """One guarded step on `batch`, or None when a replan rewound the
        run (the restored step may be earlier than this batch's index:
        the caller re-fetches; see run_elastic)."""
        c = self.config
        t_detect = time.perf_counter()
        self._apply_actions(self._consult_faults("step"), self.world)
        lost = self.leases.stale(c.heartbeat_timeout)
        if lost and len(lost) >= len(self.world):
            # every lease stale at once is indistinguishable from the
            # clock having stalled (a host suspend, a long compile):
            # re-pulse and re-check; wedged (dead) leases stay stale
            self.leases.pulse()
            lost = self.leases.stale(c.heartbeat_timeout)
        if lost:
            self._mon_loss.add()
            self._replan(lost, reason="heartbeat_stale", t0=t_detect)
            return None
        stall, self._pending_stall = self._pending_stall, 0.0
        if c.step_timeout <= 0:
            if stall:
                time.sleep(stall)
            out = self._trainer.train_step(batch)
            self.leases.pulse()
            return out
        gen = self._gen
        trainer = self._trainer
        budget = c.step_timeout
        if self.trace_count == 0:          # warmup: the pins derive
            budget *= max(c.warmup_factor, 1.0)

        def watched():
            if stall:
                time.sleep(stall)
            if gen != self._gen:
                raise _Superseded("replan superseded this dispatch")
            return trainer.train_step(batch)

        t_hang = time.perf_counter()
        try:
            loss, ok = self._puller.pull(watched, budget,
                                         retries=c.hang_retries)
        except StepHungError:
            self._mon_hang.add()
            lost = self.leases.stale(c.heartbeat_timeout)
            if not lost:
                # the hung rank is unidentifiable from a wedged
                # collective: shrink the world from the tail
                lost = self.world[-max(c.hang_shrink, 1):]
                self.leases.wedge(lost)
            self._replan(lost, reason="collective_hang", t0=t_hang)
            return None
        self.leases.pulse()
        return float(loss), bool(ok)

    # ----------------------------------------------------------- replan
    def _depart(self, code: int, why: str):
        print(f"[elastic] {self._key} leaves the world ({why}); exiting "
              f"{code}", file=sys.stderr, flush=True)
        raise ElasticDeparture(code, why)

    def _settle_writes(self) -> None:
        if self.manager is None:
            return
        try:
            self.manager.wait()
        except Exception as e:              # the restore falls back past it
            print(f"[elastic] in-flight snapshot failed at the loss: "
                  f"{e!r}", file=sys.stderr, flush=True)

    def _check_route(self, reason: str) -> None:
        """Raise where the in-process replan cannot hold, naming why."""
        import torch.distributed as dist
        if len(self.world) > 1 and not self._run_dir:
            raise RuntimeError(
                "elastic: an in-process replan of a world of "
                f"{len(self.world)} ranks needs a CheckpointManager: its "
                "root holds the leases and re-formation stores, and its "
                "snapshots are what the survivors restore; "
                "restart_on_loss=True takes the launcher's exit-101 "
                "route instead")
        if reason == "collective_hang" and dist.is_initialized() and \
                str(dist.get_backend()) == "nccl":
            raise RuntimeError(
                "elastic: a collective hang on the 'nccl' route leaves a "
                "communicator wedged in the abandoned dispatch, which an "
                "in-process re-formation cannot release; use "
                "ElasticConfig(restart_on_loss=True), the launcher's "
                "exit-101 route")

    def _degrade(self, n: int) -> TrainPlan:
        return degrade_plan(self._cfg, self.plan, n, self._gb,
                            chip=self._chip, param_specs=self._param_specs)

    def _replan(self, lost: List[str], reason: str,
                t0: Optional[float] = None) -> None:
        """Degrade onto the survivors and reshard-restore. A further loss
        at the restore boundary shrinks the survivors and re-degrades, up
        to config.max_replans attempts."""
        c = self.config
        t0 = time.perf_counter() if t0 is None else t0
        if self.replans >= max(c.max_replans, 1):
            raise RuntimeError(
                f"elastic: {self.replans} replans exhausted "
                f"(max_replans={c.max_replans}) and devices are still "
                f"being lost — giving up")
        self._gen += 1          # supersede any abandoned hung dispatch
        lost = sorted(set(lost))
        print(f"[elastic] device loss ({reason}): lost {lost} of "
              f"{len(self.world)}; replanning", file=sys.stderr, flush=True)
        self._flight.configure(elastic_reason=reason, elastic_lost=lost)
        self._flight.dump("elastic_device_loss")
        t_detect = time.perf_counter()
        self._settle_writes()
        t_settle = time.perf_counter()
        survivors = [k for k in self.world if k not in lost]
        if c.restart_on_loss:
            new_plan = self._degrade(len(survivors))
            request_degraded_restart(
                {"n_devices": new_plan.plan.n_devices,
                 "axes": new_plan.axes}, reason=reason)
        if self._key in lost:
            self._depart(DECLARED_LOST_EXIT, f"{reason}: own lease lost")
        self._check_route(reason)
        for attempt in range(max(c.max_replans, 1)):
            new_plan = self._degrade(len(survivors))
            new_world = survivors[:new_plan.plan.n_devices]
            try:
                self._restore_boundary(new_world)
            except DeviceLossError as e:
                # killed mid-restore: shrink and re-degrade
                print(f"[elastic] device loss DURING restore (attempt "
                      f"{attempt + 1}): lost {e.lost}; re-degrading",
                      file=sys.stderr, flush=True)
                self._flight.dump("elastic_device_loss")
                survivors = [s for s in survivors if s not in e.lost]
                if self._key in e.lost:
                    self._depart(DECLARED_LOST_EXIT,
                                 "own lease lost during restore")
                continue
            break
        else:
            raise RuntimeError(
                f"elastic: {c.max_replans} replans exhausted and "
                f"devices are still being lost — giving up")
        if self._key not in new_world:
            self._depart(LEFT_OUT_EXIT, f"left out of {new_plan.name}")
        self._reform(new_world)
        new_mesh = new_plan.build_mesh(device_type=self._device_type)
        t_reform = time.perf_counter()
        nbytes = self._restore_onto(new_mesh, new_plan, reason)
        self.plan, self.world, self.mesh = new_plan, new_world, new_mesh
        self.leases.reset(self.world)
        self.replans += 1
        t1 = time.perf_counter()
        self.last_replan = {"detect_s": t_detect - t0,
                            "settle_s": t_settle - t_detect,
                            "reform_s": t_reform - t_settle,
                            "restore_s": t1 - t_reform,
                            "reshard_bytes": float(nbytes)}
        ms = (t1 - t0) * 1e3
        self._mon_replans.add()
        self._mon_world.set(len(self.world))
        self._mon_replan_ms.set(round(ms, 3))
        self._mon_reshard.set(nbytes)
        self._flight.configure(elastic_plan=new_plan.name,
                               elastic_world=len(self.world))
        self._flight.note(event="elastic_replan", plan=new_plan.name,
                          step=self.step, replan_ms=round(ms, 3))
        print(f"[elastic] replanned onto {new_plan.name} "
              f"({len(self.world)} ranks) at step {self.step} in "
              f"{(t1 - t0) * 1e3:.0f} ms", file=sys.stderr, flush=True)

    def _restore_boundary(self, new_world: List[str]) -> None:
        """The restore phase's fault boundary: a `device_loss` queued
        behind the one that triggered this replan fires here (the
        killed-mid-restore drill), wedging the last leases of the world
        the attempt would restore onto."""
        k = int(self._consult_faults("restore").get("lose", 0))
        if k > 0:
            gone = new_world[-k:]
            self.leases.wedge(gone, shared=False)
            raise DeviceLossError(f"{k} device(s) lost during restore",
                                  lost=gone)

    def _reform(self, new_world: List[str]) -> None:
        """Join the survivors' new default group: destroy this rank's
        groups and meet the others on a file store named by the run's
        token and this replan's generation, ranked in survivor order."""
        import datetime
        import torch
        import torch.distributed as dist
        backend = str(dist.get_backend()) if dist.is_initialized() \
            else ("gloo" if self._device_type == "cpu" else "nccl")
        if dist.is_initialized():
            dist.destroy_process_group()
        if backend == "nccl":
            from ..device import resolve_device
            torch.cuda.set_device(resolve_device(None))
        store = os.path.join(self._run_dir or ".",
                             f"store.{self._token}.{self._gen}")
        dist.init_process_group(
            backend, init_method=f"file://{store}",
            rank=new_world.index(self._key), world_size=len(new_world),
            timeout=datetime.timedelta(seconds=REFORM_TIMEOUT_S))

    def _restore_onto(self, new_mesh, new_plan: TrainPlan,
                      reason: str) -> int:
        """Reshard-restore the newest intact snapshot onto the new plan
        and retarget the step; returns the bytes restored on this
        rank."""
        from .mesh import mesh_device
        specs = plan_state_specs(new_plan)
        state = step = None
        if self.manager is not None:
            state, step = self.manager.restore(
                mesh=new_mesh, specs=specs, device=mesh_device(new_mesh))
        shapes = self._trainer._shapes
        if state is not None:
            params = state["params"]
            opt = state.get("opt_state", self._trainer.opt_state)
            saved = state.get("step")
            step = int(saved) if saved is not None else int(step or 0)
            self.last_restore_step = step
            nbytes = _tree_nbytes(params) + _tree_nbytes(opt)
        elif getattr(self._trainer._guarded, "in_pins", None) is None:
            # no snapshot, but the trainer has not stepped: it still
            # holds the full trees, which shard onto the new plan
            params, opt = self._trainer.params, self._trainer.opt_state
            step = self._trainer.step
            nbytes = 0
            orphan = self._trainer
            self._trainer = self._make_trainer(params, opt, step=step,
                                               mesh=new_mesh, plan=new_plan)
            orphan.manager = None
            return nbytes
        else:
            raise RuntimeError(
                "elastic: no snapshot to restore onto the degraded plan, "
                "and this rank holds only its shards of the old one (the "
                "lost ranks' shards are gone); run with "
                "ResilienceConfig(checkpoint_every=N)")
        if reason == "collective_hang":
            # a fresh trainer: the abandoned watchdog thread may still
            # hold the old one, which must also lose its handle on the
            # shared manager, or a late zombie step would save the
            # abandoned timeline into the restored run's root
            orphan = self._trainer
            self._trainer = self._make_trainer(params, opt, step=step,
                                               mesh=new_mesh, plan=new_plan,
                                               shapes=shapes)
            orphan.manager = None
        else:
            # a clean boundary: retarget the SAME step object (the
            # facade's rebuild: fresh pins)
            self._trainer.rebuild_plan(new_mesh, new_plan, params=params,
                                       opt_state=opt, step=step)
        return nbytes


def run_elastic(trainer: ElasticTrainer, batch_fn, total_steps: int,
                on_step=None) -> ElasticTrainer:
    """Drive `trainer` to `total_steps` with batches keyed by step index
    (the run_resilient contract: a replan rewinds the step counter and
    the same batches re-run on the degraded plan, which makes the
    resumed trajectory comparable bit for bit with a clean restore). A
    train_step that returns None replanned instead of stepping: loop
    and re-fetch at the restored step."""
    while trainer.step < total_steps:
        step = trainer.step
        out = trainer.train_step(batch_fn(step))
        if out is None:
            continue
        loss, ok = out
        if on_step is not None:
            on_step(step, loss, ok)
    return trainer
