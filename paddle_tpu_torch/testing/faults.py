"""Deterministic fault injectors for the fault-tolerance runtime — the
port's counterpart of paddle_tpu/testing/faults.py, its training,
elastic and serving kinds.

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

The reference's router and journal kinds (`replica_preempt`,
`migrate_raise`, `quota_flood`, `sigkill`, `journal_torn`) are refused by
name until the fleet is ported (ROADMAP A7 part 3).

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
                  "decode_raise", "cow_raise", "draft_nan", "oom")
_PORTED_KINDS = ("kill", "crash_shard", "nan", "hb_stale",
                 "elastic_exit") + _ELASTIC_KINDS + _SERVING_KINDS
# the reference's other kinds, and the ROADMAP item each waits for
_WAITING = {
    k: "ROADMAP A7 part 3 (the fleet: the router and journal fault kinds)"
    for k in ("replica_preempt", "migrate_raise", "quota_flood", "sigkill",
              "journal_torn")}
_KINDS = _PORTED_KINDS + tuple(_WAITING)


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
                    f"kinds {_PORTED_KINDS})") from e
            if kind in _WAITING:
                raise ValueError(
                    f"fault kind {kind!r} in {token!r} is not ported yet: "
                    f"it waits for {_WAITING[kind]} (kinds: "
                    f"{_PORTED_KINDS})")
            if kind not in _PORTED_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {token!r} "
                    f"(kinds: {_PORTED_KINDS})")
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
        raise_decode, raise_cow, raise_oom). Each fault fires at most
        once."""
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
            elif f.kind == "oom":
                actions["raise_oom"] = True
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
    from ..inference import serving
    from ..parallel import checkpoint, elastic, resilience
    resilience._STEP_HOOK = plan.on_step
    checkpoint._SHARD_WRITE_HOOK = plan.on_shard_write
    elastic._FAULT_HOOK = plan.on_elastic
    serving._FAULT_HOOK = plan.on_serving_tick
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    from ..inference import serving
    from ..parallel import checkpoint, elastic, resilience
    resilience._STEP_HOOK = None
    checkpoint._SHARD_WRITE_HOOK = None
    elastic._FAULT_HOOK = None
    serving._FAULT_HOOK = None
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
