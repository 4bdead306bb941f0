"""Deterministic fault injectors for the fault-tolerance runtime — the
port's counterpart of paddle_tpu/testing/faults.py, with all of its
kinds: training, elastic, serving, router and journal.

Faults are declared in a spec string (env `PADDLE_TPU_FAULTS`),
injected at exact step and shard boundaries so drills are reproducible,
and fire at most once across process restarts through marker files
(env `PADDLE_TPU_FAULTS_ONCE_DIR`): a kill at step 0 that fired again on
every restart would livelock the drill.

Spec grammar, comma-separated `kind@a[:b]` tokens:

- ``kill@S``          — `os._exit(KILL_EXIT)` at the boundary before
                        step S runs (as SIGKILL: no flush, no atexit, no
                        checkpoint commit).
- ``crash_shard@S:K`` — during the snapshot save issued by the step
                        that ran batch S, die after K shard files this
                        rank wrote (a torn save; the staging directory
                        is never mistaken for a checkpoint).
- ``nan@S:M``         — poison the loss with nan for M step executions
                        from step S (count-limited, so the re-run after
                        a rollback trains clean).
- ``hb_stale@S``      — stop the liveness heartbeat at step S and wedge.
                        The port calls the step hook inside the
                        resilient trainer's watchdog budget, so with a
                        watchdog the wedge is a hung step (StepHungError,
                        or exit 101 with `exit_on_hang`); without one the
                        launcher's lease watch must kill the worker.
- ``elastic_exit@S``  — `sys.exit(ELASTIC_EXIT_CODE)` at step S.

Elastic kinds: parallel/elastic.py consults `on_elastic` through
`elastic._FAULT_HOOK` at its phase boundaries, "step" before each step
and "restore" at the start of each reshard-restore attempt; each fires
at most once, by the same marker scheme. Every rank of a world consults
the same plan at the same boundaries, so every rank draws the same
actions:

- ``device_loss@S:K``      — wedge the last K device leases at or after
                             step S (K defaults to 1): the staleness
                             check fires at that boundary and the
                             controller replans onto the survivors. At
                             most one device_loss fires a consult, so a
                             second token queued at the same step fires
                             at the next boundary, which after a loss at
                             "step" is the replan's "restore": the
                             killed-mid-restore drill.
- ``collective_hang@S:MS`` — stall the watched step MS milliseconds at
                             or after step S, inside the controller's
                             watchdog clock (MS past the budget: the
                             hang detector fires).
- ``straggler@S:MS``       — the same stall, named for the
                             within-budget case: the run slows and must
                             not replan.

Serving kinds: inference/serving.py consults `on_serving_tick` through
`serving._FAULT_HOOK` once an engine tick; the "step" coordinate is the
engine's tick, and each fires at most once by the same marker scheme:

- ``nan_logits@T:S``  — poison decode slot S's logits with nan at tick T
                        (a lane of the tick's poison multiplier, so
                        injected and organic non-finite logits meet the
                        same quarantine). S defaults to 0.
- ``draft_nan@T:S``   — poison slot S's draft logits (spec decode) at
                        tick T: the slot degrades to one token for that
                        tick (acceptance 0), never quarantine. S defaults
                        to 0; no-op on a non-spec engine.
- ``tick_stall@T:MS`` — stall tick T's host pull MS milliseconds, inside
                        the watchdog's clock (the budget/backoff path).
- ``prefill_raise@T`` — raise at the prefill seam on tick T (the
                        admission rollback and retry; the chunk retry
                        under the paged layout).
- ``decode_raise@T``  — raise at the decode seam on tick T (the re-run
                        from the host mirrors).
- ``cow_raise@T``     — raise at the next copy-on-write page copy at or
                        after tick T (paged `_ensure_private`).
- ``oom@T``           — raise a simulated allocation failure (its message
                        carries RESOURCE_EXHAUSTED) at the decode seam on
                        tick T: an `oom_forensics` dump, then the retry.

- ``migrate_raise@T``  — at the engine hook: the next `snapshot_request`
                        at or after tick T raises once (the router takes
                        the requeue-replay fallback).
- ``sigkill@T``       — at serving or router tick T: a real SIGKILL to
                        this process (no flush, no atexit). The marker is
                        fsynced first, so a restart runs clean; the
                        request journal is all that survives.

Router kinds (inference/router.py consults `on_router_tick` through
`router._FAULT_HOOK` once a router tick; inference/autoscale.py's
EnginePreemptGuard consults the same method through
`autoscale._FAULT_HOOK`, where the tick is the guard's poll index):

- ``replica_preempt@T:R`` — at the router: kill replica R at tick T
                        (migration first, replay fallback). At the
                        preempt guard: wedge the last R leases of the
                        engine's mesh. At most one fires a consult.
- ``migrate_raise@T``   — the next router migration at or after tick T
                        fails once (fallback, migrate_fallbacks).
- ``quota_flood@T:N``   — at router tick T, N low-priority submissions
                        of the "flood" tenant through the router's own
                        submit (quota and backpressure rejects
                        swallowed). N defaults to 1.
- ``sigkill@T``         — as above, at the router tick.

Journal kind (inference/journal.py consults `on_journal_recover` through
`journal._FAULT_HOOK` once a WAL recovery, before reading):

- ``journal_torn@N``    — truncate N bytes off the request WAL's tail
                        (the coordinate is the byte count): the torn
                        record drops, everything before it replays.

File corruptors (`truncate_shard`, `bitflip_shard`, `remove_shard`)
damage committed checkpoints in place and exempt them from the write
audit (`checkpoint.audit_forget`).
"""
from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["ENV_SPEC", "ENV_ONCE_DIR", "KILL_EXIT", "FaultPlan", "install",
           "uninstall", "active", "truncate_shard", "bitflip_shard",
           "remove_shard"]

ENV_SPEC = "PADDLE_TPU_FAULTS"
ENV_ONCE_DIR = "PADDLE_TPU_FAULTS_ONCE_DIR"

# Exit code of injected hard kills: distinct from ELASTIC_EXIT_CODE
# (101) and from a crash's usual 1, so drill logs attribute deaths.
KILL_EXIT = 37

_ELASTIC_KINDS = ("device_loss", "collective_hang", "straggler")
_SERVING_KINDS = ("nan_logits", "tick_stall", "prefill_raise",
                  "decode_raise", "cow_raise", "draft_nan", "migrate_raise",
                  "oom", "sigkill")
_ROUTER_KINDS = ("replica_preempt", "migrate_raise", "quota_flood",
                 "sigkill")
_JOURNAL_KINDS = ("journal_torn",)
# the reference's kind order (paddle_tpu/testing/faults.py _KINDS)
_KINDS = ("kill", "crash_shard", "nan", "hb_stale", "elastic_exit",
          "nan_logits", "tick_stall", "prefill_raise", "decode_raise",
          "cow_raise", "draft_nan", "device_loss", "collective_hang",
          "straggler", "replica_preempt", "migrate_raise", "oom",
          "quota_flood", "sigkill", "journal_torn")


@dataclass
class _Fault:
    kind: str
    step: int
    arg: int = 1          # K for crash_shard, M for nan
    token: str = ""       # marker-file name for fire-once-across-restarts
    remaining: int = 1
    done: bool = False


@dataclass
class FaultPlan:
    spec: str
    once_dir: Optional[str] = None
    faults: List[_Fault] = field(default_factory=list)
    current_step: int = -1
    fired: List[str] = field(default_factory=list)

    def __post_init__(self):
        for i, token in enumerate(t.strip() for t in self.spec.split(",")):
            if not token:
                continue
            try:
                kind, _, rest = token.partition("@")
                a, _, b = rest.partition(":")
                step, arg = int(a), int(b) if b else 1
                if kind in ("nan_logits", "draft_nan") and not b:
                    arg = 0            # default: poison slot 0
            except ValueError as e:
                raise ValueError(
                    f"bad fault token {token!r} (grammar: kind@step[:arg], "
                    f"kinds {_KINDS})") from e
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {token!r} "
                    f"(kinds: {_KINDS})")
            f = _Fault(kind, step, arg, token=f"{i}.{kind}@{step}",
                       remaining=arg if kind == "nan" else 1)
            if self._already_fired(f):
                f.done = True
            self.faults.append(f)

    # ------------------------------------------------- once-across-restarts
    def _marker(self, f: _Fault) -> Optional[str]:
        if not self.once_dir:
            return None
        return os.path.join(self.once_dir, f"fired.{f.token}")

    def _already_fired(self, f: _Fault) -> bool:
        m = self._marker(f)
        return m is not None and os.path.exists(m)

    def _mark_fired(self, f: _Fault) -> None:
        f.done = True
        self.fired.append(f.token)
        m = self._marker(f)
        if m is None:
            return
        os.makedirs(self.once_dir, exist_ok=True)
        # durably, before the destructive action: a kill that outran its
        # marker would fire again forever
        with open(m, "w") as fh:
            fh.write(f"{time.time()}\n")
            fh.flush()
            os.fsync(fh.fileno())

    # ------------------------------------------------------------ hooks
    def on_step(self, step: int) -> float:
        """resilience._STEP_HOOK: called with the step about to run;
        returns the loss poison multiplier."""
        self.current_step = step
        poison = 1.0
        for f in self.faults:
            if f.done or step < f.step:
                continue
            if f.kind == "kill":
                self._mark_fired(f)
                print(f"[faults] kill at step {step}", file=sys.stderr,
                      flush=True)
                os._exit(KILL_EXIT)
            elif f.kind == "elastic_exit":
                self._mark_fired(f)
                print(f"[faults] elastic exit at step {step}",
                      file=sys.stderr, flush=True)
                from ..distributed.launch.heartbeat import ELASTIC_EXIT_CODE
                sys.exit(ELASTIC_EXIT_CODE)
            elif f.kind == "hb_stale":
                self._mark_fired(f)
                print(f"[faults] heartbeat stalled at step {step}; "
                      f"wedging", file=sys.stderr, flush=True)
                from ..distributed.launch import heartbeat
                heartbeat.stop()
                time.sleep(3600)          # the launcher must kill us
            elif f.kind == "nan" and f.remaining > 0:
                f.remaining -= 1
                if f.remaining == 0:
                    self._mark_fired(f)
                print(f"[faults] nan poison at step {step} "
                      f"({f.remaining} left)", file=sys.stderr, flush=True)
                poison = float("nan")
        return poison

    def on_shard_write(self, count: int) -> None:
        """checkpoint._SHARD_WRITE_HOOK: called after each durably
        written shard file with this rank's running count for the
        save."""
        for f in self.faults:
            if (f.done or f.kind != "crash_shard"
                    or self.current_step != f.step or count < f.arg):
                continue
            self._mark_fired(f)
            print(f"[faults] crash mid-save (step {f.step}, after "
                  f"{count} shard files)", file=sys.stderr, flush=True)
            os._exit(KILL_EXIT)

    def on_elastic(self, phase: str, step: int) -> dict:
        """elastic._FAULT_HOOK: called at the elastic controller's phase
        boundaries with ("step"|"restore", current step); returns the
        action dict the controller applies ({"lose": K} wedges the last
        K device leases, {"stall_s": S} stalls the next watched step).
        At most one device_loss fires a consult, so queued same-step
        losses cascade into the restore phase; stalls fire only at
        "step"."""
        actions: dict = {}
        for f in self.faults:
            if f.done or f.kind not in _ELASTIC_KINDS or step < f.step:
                continue
            if f.kind == "device_loss" and "lose" not in actions:
                self._mark_fired(f)
                print(f"[faults] device_loss at {phase} (step {step}): "
                      f"losing {max(f.arg, 1)} device(s)",
                      file=sys.stderr, flush=True)
                actions["lose"] = max(f.arg, 1)
            elif f.kind in ("collective_hang", "straggler") \
                    and phase == "step" and "stall_s" not in actions:
                self._mark_fired(f)
                print(f"[faults] {f.kind} at step {step}: stalling "
                      f"{f.arg} ms", file=sys.stderr, flush=True)
                actions["stall_s"] = f.arg / 1000.0
        return actions

    def on_serving_tick(self, tick: int) -> dict:
        """serving._FAULT_HOOK: called with the engine tick about to run;
        returns the action dict the engine applies this tick (keys
        poison_slot, draft_poison_slot, stall_s, raise_prefill,
        raise_decode, raise_cow, raise_migrate, raise_oom; sigkill kills
        the process). Each fault fires at most once."""
        actions: dict = {}
        for f in self.faults:
            if f.done or f.kind not in _SERVING_KINDS or tick < f.step:
                continue
            self._mark_fired(f)
            print(f"[faults] {f.kind} at serving tick {tick} "
                  f"(arg={f.arg})", file=sys.stderr, flush=True)
            if f.kind == "nan_logits":
                actions["poison_slot"] = f.arg
            elif f.kind == "draft_nan":
                actions["draft_poison_slot"] = f.arg
            elif f.kind == "tick_stall":
                actions["stall_s"] = f.arg / 1000.0
            elif f.kind == "prefill_raise":
                actions["raise_prefill"] = True
            elif f.kind == "decode_raise":
                actions["raise_decode"] = True
            elif f.kind == "cow_raise":
                actions["raise_cow"] = True
            elif f.kind == "migrate_raise":
                actions["raise_migrate"] = True
            elif f.kind == "oom":
                actions["raise_oom"] = True
            elif f.kind == "sigkill":
                # the marker is already durable (above): a restart will
                # not fire it again. A real SIGKILL: no flush, no atexit,
                # the journal's fsynced WAL is all that survives
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
        return actions

    def on_router_tick(self, tick: int) -> dict:
        """router._FAULT_HOOK and autoscale._FAULT_HOOK: called with the
        router tick (or the preempt guard's poll index) about to run;
        returns the action dict the consumer applies (keys
        replica_preempt: the replica index at the router, the lease
        count at the guard; raise_migrate; quota_flood). Each fault fires
        at most once, and at most one replica_preempt a consult, so
        stacked preemptions land on successive ticks."""
        actions: dict = {}
        for f in self.faults:
            if f.done or f.kind not in _ROUTER_KINDS or tick < f.step:
                continue
            if f.kind == "replica_preempt":
                if "replica_preempt" in actions:
                    continue
                self._mark_fired(f)
                print(f"[faults] replica_preempt at tick {tick} "
                      f"(arg={f.arg})", file=sys.stderr, flush=True)
                # verbatim: a replica index at the router (0 is legal,
                # spelled `:0`), a lease count at the preempt guard
                actions["replica_preempt"] = f.arg
            elif f.kind == "migrate_raise":
                self._mark_fired(f)
                print(f"[faults] migrate_raise at tick {tick}",
                      file=sys.stderr, flush=True)
                actions["raise_migrate"] = True
            elif f.kind == "quota_flood":
                self._mark_fired(f)
                print(f"[faults] quota_flood at tick {tick} "
                      f"(n={max(f.arg, 1)})", file=sys.stderr, flush=True)
                actions["quota_flood"] = max(f.arg, 1)
            elif f.kind == "sigkill":
                self._mark_fired(f)
                print(f"[faults] sigkill at router tick {tick}",
                      file=sys.stderr, flush=True)
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
        return actions

    def on_journal_recover(self) -> dict:
        """journal._FAULT_HOOK: consulted once a request-WAL recovery,
        before the file is read; returns {"journal_torn": nbytes} to
        truncate the WAL's tail first (`journal_torn@N`'s coordinate is
        the byte count, not a tick). Fires at most once."""
        actions: dict = {}
        for f in self.faults:
            if f.done or f.kind not in _JOURNAL_KINDS:
                continue
            self._mark_fired(f)
            print(f"[faults] journal_torn: truncating {max(f.step, 0)} "
                  f"bytes off the WAL tail", file=sys.stderr, flush=True)
            actions["journal_torn"] = max(f.step, 0)
        return actions


_PLAN: Optional[FaultPlan] = None


def install(spec: Optional[str] = None,
            once_dir: Optional[str] = None) -> Optional[FaultPlan]:
    """Arm the hook seams from `spec` (default: $PADDLE_TPU_FAULTS).
    Returns the active plan, or None when no spec is set. Call
    `uninstall()` first to re-arm."""
    global _PLAN
    spec = spec if spec is not None else os.environ.get(ENV_SPEC, "")
    if not spec:
        return None
    once = once_dir if once_dir is not None \
        else os.environ.get(ENV_ONCE_DIR) or None
    plan = FaultPlan(spec, once_dir=once)
    from ..inference import autoscale, journal, router, serving
    from ..parallel import checkpoint, elastic, resilience
    resilience._STEP_HOOK = plan.on_step
    checkpoint._SHARD_WRITE_HOOK = plan.on_shard_write
    elastic._FAULT_HOOK = plan.on_elastic
    serving._FAULT_HOOK = plan.on_serving_tick
    router._FAULT_HOOK = plan.on_router_tick
    autoscale._FAULT_HOOK = plan.on_router_tick
    journal._FAULT_HOOK = plan.on_journal_recover
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    from ..inference import autoscale, journal, router, serving
    from ..parallel import checkpoint, elastic, resilience
    resilience._STEP_HOOK = None
    checkpoint._SHARD_WRITE_HOOK = None
    elastic._FAULT_HOOK = None
    serving._FAULT_HOOK = None
    router._FAULT_HOOK = None
    autoscale._FAULT_HOOK = None
    journal._FAULT_HOOK = None
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


# --------------------------------------------------------- file corruptors
def _shard_files(ckpt_path: str) -> List[str]:
    return sorted(f for f in os.listdir(ckpt_path) if f.endswith(".npy"))


def _forget(ckpt_path: str) -> None:
    from ..parallel.checkpoint import audit_forget
    audit_forget(ckpt_path)


def truncate_shard(ckpt_path: str, index: int = 0,
                   keep_bytes: int = 16) -> str:
    """Truncate the index-th shard file of a committed checkpoint to
    `keep_bytes` (a torn write the byte-size check must catch)."""
    name = _shard_files(ckpt_path)[index]
    path = os.path.join(ckpt_path, name)
    with open(path, "rb+") as f:
        f.truncate(keep_bytes)
    _forget(ckpt_path)
    return name


def bitflip_shard(ckpt_path: str, index: int = 0, offset: int = -1) -> str:
    """Flip one bit in the index-th shard file (same length, corrupt
    payload: only the CRC can catch it)."""
    name = _shard_files(ckpt_path)[index]
    path = os.path.join(ckpt_path, name)
    with open(path, "rb+") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        pos = size - 1 if offset < 0 else min(offset, size - 1)
        f.seek(pos)
        byte = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([byte ^ 0x01]))
    _forget(ckpt_path)
    return name


def remove_shard(ckpt_path: str, index: int = 0) -> str:
    """Delete the index-th shard file outright (the missing-data
    case)."""
    name = _shard_files(ckpt_path)[index]
    os.remove(os.path.join(ckpt_path, name))
    _forget(ckpt_path)
    return name
