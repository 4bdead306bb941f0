"""The resilient train step: non-finite skip, rollback and watchdog — the
port's counterpart of paddle_tpu/parallel/resilience.py
(`plan_state_specs` :57, `ResilienceConfig` :71, `make_resilient_step`
:87, `pull_with_watchdog` :197, `WatchdogPuller` :256,
`ResilientTrainer` :346, `run_resilient` :603, the `_STEP_HOOK` seam).

Three guards around models.facade.make_train_step:

- **skip-step**: the guarded step returns `(loss, params, opt, ok)`,
  `ok = isfinite(loss × poison) & every updated param and moment
  finite`, reduced over every rank of the mesh (one rank's non-finite
  shard makes every rank skip). The reference selects the old trees in
  its jit; the port's update writes the same tensors in place, so the
  guard copies the params and opt state into buffers it keeps (reused
  step to step) before the step and copies them back when not ok: a
  skipped step leaves every leaf equal to its pre-step value to the
  bit, an update that overflows while the loss is finite included.
  `poison` multiplies the loss (normally 1.0; the fault harness sets
  nan), so injected and organic non-finite losses take one guard.
- **rollback**: after `rollback_after` consecutive skips the trainer
  reloads the newest intact snapshot from its CheckpointManager
  (checksum-verified, falling back past corrupt ones) onto its layout
  and rewinds its step counter.
- **watchdog**: the whole guarded step (the fault hook, the dispatch,
  its collectives and the loss pull) runs under a wall-clock budget
  with bounded backoff. Eager torch over gloo blocks the host inside a
  collective whose peer died, so the budget must cover the dispatch,
  not only the pull. When it is exhausted the trainer raises
  StepHungError, or with `exit_on_hang` exits with ELASTIC_EXIT_CODE
  (101) so a launcher restarts the worker and it resumes from `LATEST`.
  After a hang the trainer's state is untrusted.

Observability, the reference's (:158-194, :411-418, :485-548):
`make_resilient_step(telemetry=)` records RESILIENT_FIELDS into the
device accumulator of a profiler.telemetry.TelemetryPipeline, the raw
(pre-guard) loss, the update norm and the non-finite count read before
the guard restores anything (the update norm against the guard's own
pre-step copies, so the state is never copied twice); the trainer
counts `resilience_steps`, `resilience_skip_step`, `resilience_rollback`
and `resilience_watchdog_hang`, sets `resilience_step_ms`, notes every
step in the flight recorder and dumps it at a rollback
('rollback') and a hang ('watchdog_hang', or 'watchdog_elastic_exit'
before the exit 101). Unlike the reference, whose accumulator cursor
runs on through a rollback while its flush cadence follows the rewound
step counter, the trainer writes the rows since the last flush at a
rollback and restarts the cursor at the restored step: the stream holds
every attempted step once, the re-run ones under their ids again.
"""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .checkpoint import _UNSET, CheckpointManager, _flatten
from ..distributed.launch.heartbeat import ELASTIC_EXIT_CODE  # noqa: F401

__all__ = ["StepHungError", "ResilienceConfig", "plan_state_specs",
           "make_resilient_step", "pull_with_watchdog", "WatchdogPuller",
           "ResilientTrainer", "run_resilient", "ELASTIC_EXIT_CODE",
           "RESILIENT_FIELDS"]

# Fault-injection seam (paddle_tpu_torch.testing.faults): called with the
# step index about to run, inside the watchdog budget; returns a loss
# multiplier (1.0, or nan to poison) and may side-effect (kill the
# process, stall). Production code never sets it.
_STEP_HOOK: Optional[Callable[[int], float]] = None


class StepHungError(RuntimeError):
    """A guarded step outlived the watchdog budget (a hung dispatch, or a
    collective whose peer is gone)."""


def plan_state_specs(plan):
    """The restore layout of a TrainPlan's trainer state: params by the
    plan's specs, Adam's m and v mirroring them leaf for leaf (the
    facade's pin rule). None when the plan carries no spec table."""
    if plan is None or not getattr(plan, "specs", None):
        return None
    return {"params": plan.specs,
            "opt_state": {"m": plan.specs, "v": plan.specs}}


@dataclass
class ResilienceConfig:
    """Knobs of ResilientTrainer (the reference's, default for
    default)."""
    rollback_after: int = 3        # consecutive skipped steps -> rollback
    max_rollbacks: int = 5         # give up (raise) after this many
    checkpoint_every: int = 0      # steps between snapshots (0 = manual)
    async_checkpoint: bool = False  # snapshots through manager.save_async
    watchdog_timeout: float = 0.0  # seconds a step (0 = no watchdog)
    retries: int = 3               # extra backoff waits after the timeout
    backoff_base: float = 2.0      # first retry wait, doubling each retry
    backoff_max: float = 60.0      # per-retry wait ceiling
    exit_on_hang: bool = False     # sys.exit(ELASTIC_EXIT_CODE) on hang


# ------------------------------------------------------------- the guard
def _tree_finite(tree) -> Optional[torch.Tensor]:
    """A 0-d bool: every floating leaf of `tree` finite (None when it has
    no floating tensor). Each leaf's min and max come from one read pass
    (`aminmax`, which propagates NaN), and a leaf is finite exactly when
    both are; `isfinite(leaf).all()` makes several passes with
    leaf-sized temporaries."""
    ends = [torch.stack(torch.aminmax(leaf)).float()
            for leaf in _flatten(tree).values()
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.numel()]
    return torch.isfinite(torch.cat(ends)).all() if ends else None


def _all_ranks(ok: torch.Tensor) -> torch.Tensor:
    """`ok` and'ed over every rank of the ambient mesh: the count of
    ranks not ok, summed over each mesh axis in turn (so over the whole
    mesh), on the step's collective route."""
    from .collective import all_reduce
    from .mesh import axis_group, axis_names, get_mesh
    mesh = get_mesh()
    if mesh is None:
        return ok
    bad = (~ok).to(torch.float32).reshape(1)
    for axis in axis_names(mesh):
        bad = all_reduce(bad, axis_group(mesh, axis))
    return bad.reshape(()) == 0


class _Backup:
    """Pre-step copies of the state's tensor leaves, in buffers kept
    from step to step (made again only when a leaf's shape, dtype or
    device changes, as after a rebuild)."""

    def __init__(self):
        self.bufs = {}
        self.nbytes = 0

    def save(self, *trees) -> None:
        flat = _flatten(list(trees))
        nbytes = 0
        for key, leaf in flat.items():
            if not isinstance(leaf, torch.Tensor):
                continue
            buf = self.bufs.get(key)
            if (buf is None or buf.shape != leaf.shape
                    or buf.dtype != leaf.dtype or buf.device != leaf.device):
                buf = self.bufs[key] = torch.empty_like(leaf)
            buf.copy_(leaf)
            nbytes += leaf.numel() * leaf.element_size()
        self.nbytes = nbytes

    def restore(self, *trees) -> None:
        for key, leaf in _flatten(list(trees)).items():
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(self.bufs[key])

    def update_sumsq(self, params, reducer=None):
        """The (mesh-weighted) sum over the param leaves of
        ||leaf - its pre-step copy||² (0-d f32), the params being the
        first tree saved; None without a floating leaf."""
        from ..profiler.telemetry import _weighted
        parts, weights = [], []
        for key, leaf in _flatten(params, "#0/").items():
            if not (isinstance(leaf, torch.Tensor)
                    and leaf.is_floating_point() and leaf.numel()):
                continue
            parts.append(torch.square(torch.linalg.vector_norm(
                leaf.float() - self.bufs[key].float())))
            weights.append(1.0 if reducer is None
                           else reducer.weight(0, key.split("/")[1:]))
        return _weighted(parts, weights)


def make_resilient_step(step_fn, cfg=None, telemetry=None, mesh=None,
                        plan=None, **step_kw):
    """The guarded step `(params, opt_state, batch, poison) -> (loss,
    params, opt_state, ok)` over `step_fn(params, opt_state, batch, ...)
    -> (loss, params, opt_state)`, the contract of
    models.facade.make_train_step, whose step it is: with `mesh` and
    `plan` the planner-driven sharded step (dp×fsdp×tp, or pipelined for
    a pp>1 plan through plan_step_cell, so `rebuild` can move it to
    another plan). `ok` is a 0-d bool tensor, the same on every rank;
    when it is false the returned trees are the inputs with their
    pre-step values and the loss is nan, so one pull of the loss tells
    both.

    With `telemetry` (a profiler.telemetry.TelemetryPipeline) the step
    also takes and returns the device accumulator, `(params, opt_state,
    batch, poison, tstate) -> (loss, params, opt_state, ok, tstate)`,
    and records the fields of RESILIENT_FIELDS it declares: the raw loss
    (× poison, before the guard folds it to nan), the update global norm
    and the non-finite count of the updated params (read before a
    restore, so a diverging run shows its blow-up), the param global
    norm of the kept params, and ok. Under a mesh each is the whole
    model's, every block counted once."""
    from ..models.facade import make_train_step, plan_step_cell
    cell = plan_step_cell(step_fn, cfg=cfg, mesh=mesh, plan=plan,
                          **step_kw)
    backup = _Backup()
    box = {}

    def guarded(params, opt_state, batch, poison=1.0, tstate=None):
        backup.save(params, opt_state)
        loss, new_params, new_opt = cell.fn(params, opt_state, batch)[:3]
        loss = loss * poison
        ok = torch.isfinite(loss)
        for tree in (new_params, new_opt):
            fin = _tree_finite(tree)
            if fin is not None:
                ok = ok & fin.to(ok.device)
        ok = _all_ranks(ok)
        if telemetry is not None:
            # queued before the restore below, so they read the raw update
            red = _reducer(box)
            raw = _raw_partials(telemetry, red, backup, new_params)
        if bool(ok):
            out = (loss, new_params, new_opt, ok)
        else:
            backup.restore(params, opt_state)
            out = (torch.full_like(loss, float("nan")), params, opt_state,
                   ok)
        if telemetry is None:
            return out
        _record(telemetry, red, tstate, raw, loss, out[1], ok)
        return out + (tstate,)

    guarded._plan_cell = cell
    guarded.backup = backup
    step = make_train_step(guarded, mesh=mesh, plan=plan)
    if step is not guarded:
        box["step"] = step
    return step


# the telemetry fields of the resilient step (DEFAULT_FIELDS' grad_norm
# and lr are not the guard's to see): TelemetryPipeline(fields=...)
RESILIENT_FIELDS = ("loss", "update_norm", "param_norm", "nonfinite", "ok")


def _reducer(box):
    from ..profiler.telemetry import _Reducer
    pins = getattr(box.get("step"), "in_pins", None)
    return _Reducer(pins) if pins is not None else None


def _raw_partials(telemetry, red, backup, new_params):
    """This rank's partial sums of the raw update: the update's sum of
    squares and the updated params' non-finite count."""
    from ..profiler.telemetry import _nonfinite
    want = set(telemetry.fields)
    return {"update_norm": backup.update_sumsq(new_params, red)
            if "update_norm" in want else None,
            "nonfinite": _nonfinite(new_params, red)
            if "nonfinite" in want else None}


def _record(telemetry, red, tstate, raw, loss, kept_params, ok):
    """Reduce the partial sums over the mesh in one vector and write the
    row."""
    from ..profiler.telemetry import _sumsq
    parts = dict(raw)
    if "param_norm" in telemetry.fields:
        parts["param_norm"] = _sumsq(kept_params, red)
    names = [k for k, v in parts.items() if v is not None]
    scalars = {}
    if names:
        vec = torch.stack([parts[k].to(torch.float32) for k in names])
        if red is not None:
            vec = red.sum(vec)
        for k, v in zip(names, vec):
            scalars[k] = v.round() if k == "nonfinite" else torch.sqrt(v)
    scalars["loss"] = loss
    scalars["ok"] = ok.to(torch.float32)
    telemetry.device_record(tstate, **{k: v for k, v in scalars.items()
                                       if k in telemetry.fields})


# ------------------------------------------------------------- watchdog
def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def pull_with_watchdog(value, timeout: float, retries: int = 3,
                       backoff_base: float = 2.0,
                       backoff_max: float = 60.0,
                       label: str = "step",
                       on_retry=None) -> np.ndarray:
    """Force `value` (a tensor or array, or a zero-arg callable producing
    one, which then runs entirely under the clock) to a host array under
    a wall-clock budget, in a worker thread. The first wait is
    `timeout`; each of `retries` further waits doubles from
    `backoff_base` (capped at `backoff_max`), polling the same work.
    `on_retry` observes each backoff's attempt index. Raises
    StepHungError when the budget is exhausted."""
    def force():
        return _host(value() if callable(value) else value)

    if timeout <= 0:
        return force()
    box: dict = {}

    def work():
        try:
            box["val"] = force()
        except BaseException as e:          # surfaced to the caller
            box["err"] = e

    t = threading.Thread(target=work, name="paddle-watchdog-pull",
                         daemon=True)
    t.start()
    waited = 0.0
    for attempt in range(retries + 1):
        grace = timeout if attempt == 0 else min(
            backoff_base * (2.0 ** (attempt - 1)), backoff_max)
        t.join(grace)
        waited += grace
        if not t.is_alive():
            break
        if attempt < retries:
            print(f"[resilience] {label} pull stalled {waited:.1f}s "
                  f"(attempt {attempt + 1}/{retries + 1}); backing off",
                  file=sys.stderr, flush=True)
            if on_retry is not None:
                on_retry(attempt)
    if t.is_alive():
        raise StepHungError(
            f"{label} result did not arrive within {waited:.1f}s "
            f"(watchdog {timeout}s + {retries} backoff retries) — hung "
            f"dispatch")
    if "err" in box:
        raise box["err"]
    return box["val"]


class WatchdogPuller:
    """`pull_with_watchdog` on one persistent worker thread (a fresh
    thread a call costs more than a frequent caller's budget): each pull
    is a queue round trip under the same budget and backoff. Responses
    carry a sequence number, so a pull that outlived its budget cannot
    deliver its late result to a later call; after a hang the wedged
    worker is abandoned and the next pull starts a fresh one. Tuple
    results pass through element by element."""

    def __init__(self, label: str = "pull"):
        import queue
        self._label = label
        self._req: "queue.SimpleQueue" = queue.SimpleQueue()
        self._res: "queue.SimpleQueue" = queue.SimpleQueue()
        self._seq = 0
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _convert(res):
        return (tuple(_host(v) for v in res) if isinstance(res, tuple)
                else _host(res))

    def _ensure(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, args=(self._req, self._res),
                name=f"paddle-watchdog-{self._label}", daemon=True)
            self._thread.start()

    def _loop(self, req, res_q) -> None:
        while True:
            seq, value = req.get()
            try:
                res = value() if callable(value) else value
                res_q.put((seq, "ok", self._convert(res)))
            except BaseException as e:      # surfaced to the caller
                res_q.put((seq, "err", e))

    def pull(self, value, timeout: float, retries: int = 3,
             backoff_base: float = 2.0, backoff_max: float = 60.0,
             on_retry=None):
        """pull_with_watchdog's contract on the persistent worker."""
        import queue
        if timeout <= 0:
            return self._convert(value() if callable(value) else value)
        self._ensure()
        self._seq += 1
        seq = self._seq
        self._req.put((seq, value))
        waited, attempt = 0.0, 0
        while attempt <= retries:
            grace = timeout if attempt == 0 else min(
                backoff_base * (2.0 ** (attempt - 1)), backoff_max)
            try:
                rseq, kind, payload = self._res.get(timeout=grace)
            except queue.Empty:
                waited += grace
                if attempt < retries:
                    print(f"[resilience] {self._label} pull stalled "
                          f"{waited:.1f}s (attempt {attempt + 1}/"
                          f"{retries + 1}); backing off",
                          file=sys.stderr, flush=True)
                    if on_retry is not None:
                        on_retry(attempt)
                attempt += 1
                continue
            if rseq != seq:
                continue       # late result of a previously hung pull
            if kind == "err":
                raise payload
            return payload
        # the worker is wedged: abandon it with its queues
        self._thread = None
        self._req = queue.SimpleQueue()
        self._res = queue.SimpleQueue()
        raise StepHungError(
            f"{self._label} result did not arrive within {waited:.1f}s "
            f"(watchdog {timeout}s + {retries} backoff retries) — hung "
            f"dispatch")


# ------------------------------------------------------------- trainer
def _shape_tree(tree):
    """The full shapes of a tree's array leaves (scalars: ())."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(getattr(tree, "shape", ()))


def _first_device(tree):
    for leaf in _flatten(tree).values():
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


class ResilientTrainer:
    """Owns (params, opt_state, step) and runs guarded steps with skip,
    rollback and watchdog, the heartbeat, and periodic snapshots.

        mgr = CheckpointManager(root, max_to_keep=3)
        tr = ResilientTrainer(llama.train_step, params, opt, cfg=cfg,
                              manager=mgr, mesh=mesh, plan=plan,
                              config=ResilienceConfig(checkpoint_every=1))
        tr.maybe_resume()            # a restart continues from LATEST
        while tr.step < total:
            loss, ok = tr.train_step(batch_for(tr.step))

    With a real `mesh` and `plan` the step is the planner-driven one,
    and `params`/`opt_state` are given as FULL trees (the first step
    shards them, as the facade's first call does); restores land each
    rank's block of the plan's layout (`plan_state_specs`) on the mesh's
    device. Without, restores land on the device of the given params.
    `mesh=` alone (no plan) sets only the restore layout. The optimizer
    keywords (`lr`, ...) go through `step_kw`.

    With `telemetry` (a TelemetryPipeline, fields from RESILIENT_FIELDS)
    the accumulator is made at the first step on the trainer's device,
    its cursor seeded from the step then (a resumed run continues its
    ids), ticked after every step, and written out and restarted at the
    restored step on a rollback, a resume or a replan. The trainer's
    flight recorder installs its exit hooks; dumps go nowhere until a
    directory is set ($PADDLE_TPU_FLIGHT_DIR, which the launcher
    exports)."""

    def __init__(self, step_fn, params, opt_state, *, cfg=None,
                 manager: Optional[CheckpointManager] = None,
                 config: Optional[ResilienceConfig] = None,
                 step: int = 0, mesh=_UNSET, specs=None, telemetry=None,
                 plan=None, **step_kw):
        self.config = config or ResilienceConfig()
        # the restore layout: rollbacks reload onto the layout the
        # trainer runs, not whatever mesh is ambient then
        self._mesh = mesh
        self._specs = specs
        step_mesh = mesh if (plan is not None
                             and mesh not in (_UNSET, None)) else None
        if plan is not None and specs is None and plan.specs:
            self._specs = plan_state_specs(plan)
        self._guarded = make_resilient_step(step_fn, cfg=cfg,
                                            telemetry=telemetry,
                                            mesh=step_mesh, plan=plan,
                                            **step_kw)
        self._sharded = step_mesh is not None
        # full shapes, for pinning a step whose state comes back local
        self._shapes = (_shape_tree(params), _shape_tree(opt_state))
        if step_mesh is not None:
            from .mesh import mesh_device
            self._device = mesh_device(step_mesh)
        else:
            self._device = _first_device(params)
        self.params = params
        self.opt_state = opt_state
        self.step = int(step)
        self.manager = manager
        self.skipped = 0
        self.rollbacks = 0
        self._bad_streak = 0
        self._puller = WatchdogPuller(label="step")
        self.telemetry = telemetry
        self._tstate = None
        # liveness: a no-op unless the launcher exported the contract
        from ..distributed.launch import heartbeat
        heartbeat.start_from_env()
        self._heartbeat = heartbeat
        from ..profiler import flight_recorder, monitor
        self._mon_skip = monitor.counter("resilience_skip_step")
        self._mon_rollback = monitor.counter("resilience_rollback")
        self._mon_hang = monitor.counter("resilience_watchdog_hang")
        self._mon_steps = monitor.counter("resilience_steps")
        self._mon_step_ms = monitor.gauge("resilience_step_ms")
        self._flight = flight_recorder.recorder()
        self._flight.install_exit_hooks()
        c = self.config
        self._flight.configure(
            trainer="ResilientTrainer", start_step=self.step,
            rollback_after=c.rollback_after, max_rollbacks=c.max_rollbacks,
            checkpoint_every=c.checkpoint_every,
            watchdog_timeout=c.watchdog_timeout)

    # ------------------------------------------------------------- state
    def _restore_device(self):
        return self._device if self._device is not None else "cpu"

    def _restart_cursor(self) -> None:
        """Write the accumulator's rows since the last flush and drop it:
        the next step makes a fresh one seeded from the (rewound) step."""
        if self.telemetry is not None and self._tstate is not None:
            self.telemetry.flush_tail(self._tstate)
        self._tstate = None

    def _install(self, state, step) -> None:
        self._restart_cursor()
        self.params = state["params"]
        self.opt_state = state.get("opt_state", self.opt_state)
        saved = state.get("step")
        self.step = int(saved) if saved is not None else int(step or 0)
        if self._sharded and self._guarded.in_pins is None:
            self._guarded.adopt_shapes(*self._shapes)

    def _shardings(self):
        pins = getattr(self._guarded, "in_pins", None)
        if pins is None:
            return None
        return {"params": pins[0], "opt_state": pins[1]}

    # ------------------------------------------------------------- resume
    def maybe_resume(self, mesh=_UNSET, specs=None) -> bool:
        """Load the newest intact snapshot (LATEST first) if one exists;
        True when state was restored. An explicit `mesh`/`specs` also
        becomes the layout rollbacks reload onto."""
        if self.manager is None:
            return False
        if mesh is not _UNSET:
            self._mesh = mesh
        if specs is not None:
            self._specs = specs
        state, step = self.manager.restore(mesh=self._mesh,
                                           specs=self._specs,
                                           device=self._restore_device())
        if state is None:
            return False
        self._install(state, step)
        return True

    # ------------------------------------------------------------- replan
    def rebuild_plan(self, mesh, plan, *, params=None, opt_state=None,
                     step=None) -> None:
        """Retarget the guarded step at another mesh and plan through the
        facade's `_ShardedTrainStep.rebuild` (the same step object; a
        pipelined inner is made again for a pp plan), swap the restore
        layout to the new plan's specs, and install the state restored
        onto it (`params`/`opt_state`: this rank's blocks under the new
        plan, as `manager.restore(mesh=mesh,
        specs=plan_state_specs(plan))` gives them). Local shards of the
        old plan cannot run on the new one, so once the trainer has
        stepped the restored state must be given."""
        if not hasattr(self._guarded, "rebuild"):
            raise TypeError(
                "rebuild_plan needs the planner-driven sharded step "
                "(a trainer built with mesh= and plan=); the single-device "
                "step has no mesh to retarget")
        if params is None and self._guarded.in_pins is not None:
            raise ValueError(
                "rebuild_plan: this rank's params are shards of the old "
                "plan; pass the state restored onto the new one "
                "(manager.restore(mesh=mesh, "
                "specs=plan_state_specs(plan)))")
        self._guarded.rebuild(mesh=mesh, plan=plan)
        self._restart_cursor()
        self._mesh = mesh
        if plan is not None and plan.specs:
            self._specs = plan_state_specs(plan)
        from .mesh import mesh_device
        self._device = mesh_device(mesh)
        if params is not None:
            self.params = params
            self._guarded.adopt_shapes(*self._shapes)
        if opt_state is not None:
            self.opt_state = opt_state
        if step is not None:
            self.step = int(step)
        self._bad_streak = 0

    # --------------------------------------------------------------- save
    def save(self) -> Optional[str]:
        """Snapshot the live state (each rank its blocks). With
        config.async_checkpoint the host snapshot is taken here and the
        commit happens off the step path; manager.wait() is the barrier
        (rollback and restore take it)."""
        if self.manager is None:
            return None
        state = {"params": self.params, "opt_state": self.opt_state,
                 "step": np.int64(self.step)}
        if self.config.async_checkpoint:
            return self.manager.save_async(state, self.step,
                                           shardings=self._shardings())
        return self.manager.save(state, self.step,
                                 shardings=self._shardings())

    # --------------------------------------------------------------- step
    def _run_step(self, batch, box):
        """The watched work: the fault hook, the guarded step and the
        loss pull."""
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        poison = 1.0
        if _STEP_HOOK is not None:
            poison = _STEP_HOOK(self.step)
        if self.telemetry is not None:
            if self._tstate is None:
                self._tstate = self.telemetry.device_init(
                    start=self.step, device=self._restore_device())
            loss, params, opt, _ok, _ = self._guarded(
                self.params, self.opt_state, batch, poison, self._tstate)
        else:
            loss, params, opt, _ok = self._guarded(
                self.params, self.opt_state, batch, poison)
        box["state"] = (params, opt)
        # the guard folds every badness into a nan loss, so the one
        # pull of the loss tells ok as well
        return np.float64(float(loss))

    def train_step(self, batch) -> tuple:
        """Run one guarded step on `batch`. Returns `(loss, ok)`, `loss`
        a host float (nan on a skipped step). Raises StepHungError when
        the watchdog budget is exhausted and `exit_on_hang` is off; exits
        with ELASTIC_EXIT_CODE when it is on. After a hang the trainer's
        state is untrusted: a restarted process resumes through
        `maybe_resume()`."""
        c = self.config
        box = {}
        t0 = time.perf_counter()
        try:
            loss_host = float(self._puller.pull(
                lambda: self._run_step(batch, box), c.watchdog_timeout,
                c.retries, c.backoff_base, c.backoff_max))
        except StepHungError as e:
            self._mon_hang.add()
            self._flight.configure(last_error=str(e))
            if c.exit_on_hang:
                self._flight.dump("watchdog_elastic_exit")
                print(f"[resilience] {e}; exiting {ELASTIC_EXIT_CODE} for "
                      f"elastic restart", file=sys.stderr, flush=True)
                sys.exit(ELASTIC_EXIT_CODE)
            self._flight.dump("watchdog_hang")
            raise
        ok_host = bool(np.isfinite(loss_host))
        self.params, self.opt_state = box["state"]
        self._heartbeat.pulse()
        self.step += 1
        dur_s = time.perf_counter() - t0
        self._mon_steps.add()
        self._mon_step_ms.set(dur_s * 1e3)
        self._flight.note(step=self.step - 1, loss=loss_host, ok=ok_host,
                          dur_s=round(dur_s, 6))
        if self.telemetry is not None:
            self.telemetry.tick(self.step - 1, self._tstate)
        if ok_host:
            self._bad_streak = 0
            if (self.manager is not None and c.checkpoint_every > 0
                    and self.step % c.checkpoint_every == 0):
                self.save()
        else:
            self.skipped += 1
            self._bad_streak += 1
            self._mon_skip.add()
            print(f"[resilience] non-finite loss at step "
                  f"{self.step - 1}: update skipped "
                  f"({self._bad_streak}/{c.rollback_after} before "
                  f"rollback)", file=sys.stderr, flush=True)
            if self._bad_streak >= c.rollback_after:
                self._rollback()
        return loss_host, ok_host

    def _rollback(self) -> None:
        self._mon_rollback.add()
        # the black box holds the bad streak before the state rewinds
        self._flight.dump("rollback")
        if self.manager is None:
            # nothing to roll back to: limp on with skips alone
            self._bad_streak = 0
            return
        if self.rollbacks >= self.config.max_rollbacks:
            raise RuntimeError(
                f"resilience: {self.rollbacks} rollbacks exhausted and "
                f"the loss is still non-finite — giving up")
        state, step = self.manager.restore(mesh=self._mesh,
                                           specs=self._specs,
                                           device=self._restore_device())
        if state is None:
            # non-finite before the first snapshot: continue with skips
            # rather than turn a recoverable run into a crash
            print("[resilience] rollback requested but no snapshot "
                  "exists yet; continuing with skip-only recovery",
                  file=sys.stderr, flush=True)
            self._bad_streak = 0
            return
        self._install(state, step)
        self.rollbacks += 1
        self._bad_streak = 0
        print(f"[resilience] rolled back to step {self.step} "
              f"(rollback {self.rollbacks}/{self.config.max_rollbacks})",
              file=sys.stderr, flush=True)


def run_resilient(trainer: ResilientTrainer, batch_fn, total_steps: int,
                  on_step: Optional[Callable[[int, float, bool], Any]]
                  = None):
    """Drive `trainer` to `total_steps`, fetching `batch_fn(step)` a step
    (batches keyed by step index make the re-run after a rollback
    bit-identical). `on_step` observes `(step_just_run, loss, ok)`."""
    while trainer.step < total_steps:
        step = trainer.step
        loss, ok = trainer.train_step(batch_fn(step))
        if on_step is not None:
            on_step(step, loss, ok)
    return trainer
