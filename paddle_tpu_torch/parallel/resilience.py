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

`make_resilient_step(telemetry=)` (the reference's device telemetry
accumulator), the monitor counters and gauges and the flight-recorder
dumps wait for ROADMAP A7; each call site keeps a one-line comment.
"""
from __future__ import annotations

import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .checkpoint import _UNSET, CheckpointManager, _flatten
from ..distributed.launch.heartbeat import ELASTIC_EXIT_CODE  # noqa: F401

__all__ = ["StepHungError", "ResilienceConfig", "plan_state_specs",
           "make_resilient_step", "pull_with_watchdog", "WatchdogPuller",
           "ResilientTrainer", "run_resilient", "ELASTIC_EXIT_CODE"]

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
    both. `telemetry` waits for ROADMAP A7 (the device telemetry
    accumulator) and raises."""
    if telemetry is not None:
        raise NotImplementedError(
            "make_resilient_step(telemetry=...): the device telemetry "
            "accumulator (paddle_tpu/profiler/telemetry.py) is not ported "
            "yet; it waits for ROADMAP A7")
    from ..models.facade import make_train_step, plan_step_cell
    cell = plan_step_cell(step_fn, cfg=cfg, mesh=mesh, plan=plan,
                          **step_kw)
    backup = _Backup()

    def guarded(params, opt_state, batch, poison=1.0):
        backup.save(params, opt_state)
        loss, new_params, new_opt = cell.fn(params, opt_state, batch)[:3]
        loss = loss * poison
        ok = torch.isfinite(loss)
        for tree in (new_params, new_opt):
            fin = _tree_finite(tree)
            if fin is not None:
                ok = ok & fin.to(ok.device)
        ok = _all_ranks(ok)
        if bool(ok):
            return loss, new_params, new_opt, ok
        backup.restore(params, opt_state)
        return torch.full_like(loss, float("nan")), params, opt_state, ok

    guarded._plan_cell = cell
    guarded.backup = backup
    return make_train_step(guarded, mesh=mesh, plan=plan)


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
    keywords (`lr`, ...) go through `step_kw`."""

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
        # liveness: a no-op unless the launcher exported the contract
        from ..distributed.launch import heartbeat
        heartbeat.start_from_env()
        self._heartbeat = heartbeat
        # waits for A7: the resilience_* monitor counters and gauges and
        # the flight recorder's configure/exit hooks

    # ------------------------------------------------------------- state
    def _restore_device(self):
        return self._device if self._device is not None else "cpu"

    def _install(self, state, step) -> None:
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
        loss, params, opt, _ok = self._guarded(self.params, self.opt_state,
                                               batch, poison)
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
        try:
            loss_host = float(self._puller.pull(
                lambda: self._run_step(batch, box), c.watchdog_timeout,
                c.retries, c.backoff_base, c.backoff_max))
        except StepHungError as e:
            # waits for A7: the resilience_watchdog_hang counter and the
            # watchdog_hang / watchdog_elastic_exit flight dumps
            if c.exit_on_hang:
                print(f"[resilience] {e}; exiting {ELASTIC_EXIT_CODE} for "
                      f"elastic restart", file=sys.stderr, flush=True)
                sys.exit(ELASTIC_EXIT_CODE)
            raise
        ok_host = bool(np.isfinite(loss_host))
        self.params, self.opt_state = box["state"]
        self._heartbeat.pulse()
        self.step += 1
        # waits for A7: the resilience_steps counter, resilience_step_ms
        # gauge and the flight recorder's per-step note
        if ok_host:
            self._bad_streak = 0
            if (self.manager is not None and c.checkpoint_every > 0
                    and self.step % c.checkpoint_every == 0):
                self.save()
        else:
            self.skipped += 1
            self._bad_streak += 1
            print(f"[resilience] non-finite loss at step "
                  f"{self.step - 1}: update skipped "
                  f"({self._bad_streak}/{c.rollback_after} before "
                  f"rollback)", file=sys.stderr, flush=True)
            if self._bad_streak >= c.rollback_after:
                self._rollback()
        return loss_host, ok_host

    def _rollback(self) -> None:
        # waits for A7: the resilience_rollback counter and the rollback
        # flight dump
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
