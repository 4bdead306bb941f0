"""Multi-engine serving router: ServingEngine replicas behind
least-loaded admission, with live migration, requeue-replay, roles,
tenancy, suspension, a crash-safe journal and fleet elasticity.

Counterpart of paddle_tpu/inference/router.py (the port keeps its own
copy; the router is host code over its engines). Each replica is a full
continuous-batching ServingEngine (inference/serving.py) with its own
slot pool, KV cache (dense or paged), CUDA graphs and guardrails; the
router owns no device state.

Scheduling: `submit` places each request on the live replica with the
smallest load (in-slot + queued requests, join-shortest-queue); a
replica that refuses (its own `max_queue` backpressure or page-pool
admission) falls through to the next, and only when every live replica
refuses does the router queue (bounded by its `max_queue` with the same
reject/shed_oldest policies, reusing BackpressureError). Inner terminals
translate to the router's own exactly-once resolution.

Replica death (`kill_replica`, or any exception escaping a replica's
step): every un-terminal request of the dead replica moves to a
survivor. Live migration first: `ServingEngine.snapshot_request` pulls
the request's K/V (pages or cache rows) and decode-state mirror to the
host, and `restore_request` writes them into a survivor's cache in place
through the admission-reservation path, so the stream continues with
zero re-prefilled tokens and the continuation of an undisturbed engine.
Where no snapshot exists (the step raised, the request was mid-prefill,
no survivor has room) the request requeues at the head of the router
queue and replays from scratch (`RouterRequest.tokens` reset, so the
final list never duplicates): at-least-once token delivery,
exactly-once terminal resolution. A death with no live replica left
resolves everything "evicted". Every death leaves a flight dump.

Prefill/decode disaggregation (`roles=`): "prefill" replicas take every
new admission, and the per-tick handoff sweep moves each stream to a
"decode" replica the moment its prefill finishes, through the same
migration seam. Roles are placement preferences: a fleet degraded to one
capability falls back to the whole dispatchable set.

Fleet elasticity (`spawn_replica` / `drain_replica`) is the seam
`inference/autoscale.py`'s loop drives; a draining replica admits
nothing, keeps stepping, migrates its live requests out where it can and
is released at the first tick it holds no work. Deadlines re-scope to
the remaining budget at every (re)dispatch and migration; an exhausted
budget resolves "timeout" at once. `testing/faults.py` injects
`replica_preempt@T:R`, `migrate_raise`, `quota_flood` and `sigkill`
through this module's `_FAULT_HOOK` (consulted once a router tick).

Tenancy (`admission=`, inference/admission.py): per-tenant token-bucket
quotas, weighted-fair dispatch order, and preempt-to-host: a
high-priority submit that finds no free slot suspends the lowest
strictly-lower-priority mid-decode stream into a router-owned
HostKVTier through the same snapshot seam, and it resumes later with
zero re-prefill. `journal_dir=` adds the crash-safe request WAL
(inference/journal.py): acceptance is durable before submit() returns,
every terminal is journaled in `_finish`, and a router rebuilt over the
same directory replays the crashed process's un-terminal requests. The
brownout ladder (inference/brownout.py) drives `set_spec_drafts`,
`set_resume_hold`, `suspend_lowest_class` and `shed_oldest_pending`.

Stepping: `concurrent=True` steps the replicas on a thread pool (one
worker a replica), so one replica's host work overlaps another's device
work; the engines capture their CUDA graphs one at a time in
thread-local mode (inference/serving.py), so a capture and another
thread's launches coexist. Replicas that are tensor-parallel
(`mesh=`, tp > 1) are stepped serially on the calling thread in index
order: every rank runs this same router, and the replicas' collectives
must be issued in one order on every rank, which threads would not
keep. All router bookkeeping stays on the calling thread, so emission
order is deterministic (replica index, slot order).

Observability: serving.router.* (replicas_live, pending, suspended,
requeues, rejected, requests_submitted/completed, replica_deaths,
handoffs, dispatch_ms, queue_depth.r<i>, dispatched.r<i>) and
serving.autoscale.{migrations,migrate_fallbacks,migrated_pages_bytes},
summarized by tools/telemetry_report.py's "router" and "autoscale"
blocks.
"""
from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence

import numpy as np

from .admission import AdmissionController, QuotaExceededError
from .host_kv import HostKVTier
from .serving import (BackpressureError, PoolExhaustedError,
                      ServingEngine, TERMINAL_REASONS)
from ..profiler import monitor

__all__ = ["EngineRouter", "RouterRequest", "create_router"]

# testing/faults.py installs a callable here: called once per router
# tick as _FAULT_HOOK(tick) -> dict of actions, e.g.
# {"replica_preempt": idx} (kill replica idx, migration-first),
# {"raise_migrate": True} (the NEXT migration attempt fails once and
# takes the requeue-replay fallback) or {"quota_flood": n} (burst n
# low-priority flood-tenant submissions). None in production.
_FAULT_HOOK = None


class RouterRequest:
    """One generation request riding through the router. Mirrors the
    engine Request surface the schedulers and chaos checks read
    (tokens / done / finish_reason / slot / cancel()); `replica` is the
    index currently serving it (None while queued), `requeues` counts
    replica-death migrations."""

    __slots__ = ("id", "prompt", "max_new_tokens", "temperature",
                 "top_k", "eos_id", "deadline_s", "deadline_ticks",
                 "tokens", "done", "finish_reason", "replica",
                 "requeues", "t_submit", "_tick_submit", "_inner",
                 "_router", "trace", "tenant", "priority", "suspended")

    def __init__(self, req_id, prompt, max_new_tokens, temperature,
                 top_k, eos_id, deadline_s, deadline_ticks,
                 tenant: str = "default", priority: int = 0):
        self.id = req_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.deadline_s = deadline_s
        self.deadline_ticks = deadline_ticks
        self.tokens: List[int] = []
        self.done = False
        self.finish_reason: Optional[str] = None
        self.replica: Optional[int] = None
        self.requeues = 0
        self.t_submit = 0.0
        self._tick_submit = 0
        self._inner = None              # live engine Request, if placed
        self._router = None
        self.trace = None               # RequestTrace (tracing=True) —
        #                                 ONE tree across dispatch/replay
        # multi-tenant admission labels (inference/admission.py) +
        # the preempt-to-host parked state (KV in the router's tier)
        self.tenant = str(tenant)
        self.priority = int(priority)
        self.suspended = False

    @property
    def slot(self):
        """The engine slot currently decoding this request (None while
        queued or terminal) — the surface chaos_serving's
        check_terminal reads."""
        inner = self._inner
        return None if inner is None else inner.slot

    def cancel(self) -> bool:
        r = self._router
        return False if r is None else r.cancel(self)

    def __repr__(self):
        return (f"RouterRequest(id={self.id}, replica={self.replica}, "
                f"gen={len(self.tokens)}/{self.max_new_tokens}, "
                f"requeues={self.requeues}, done={self.done})")


ROLES = ("any", "prefill", "decode")


class _Replica:
    def __init__(self, idx: int, eng: ServingEngine, role: str = "any"):
        if role not in ROLES:
            raise ValueError(f"replica role {role!r} (any|prefill|decode)")
        self.idx = idx
        self.eng = eng
        # disaggregation role: "prefill" replicas admit new requests
        # (chunked prefill + first tokens) and hand mid-decode streams
        # off to "decode" replicas; "any" does both. The role is a
        # ROUTER placement preference — the engine underneath always
        # runs whatever it holds, so a request on a prefill replica
        # keeps decoding in place until a handoff slot frees (no stall)
        self.role = role
        self.alive = True
        self.draining = False           # admits nothing, still stepped
        self.inner = {}                 # inner request id -> RouterRequest
        self.m_depth = monitor.gauge(f"serving.router.queue_depth.r{idx}")
        self.m_disp = monitor.counter(f"serving.router.dispatched.r{idx}")

    @property
    def can_prefill(self) -> bool:
        return self.role != "decode"

    @property
    def can_decode(self) -> bool:
        return self.role != "prefill"

    def load(self) -> int:
        """In-flight demand: occupied slots (active or mid-prefill) +
        the engine's own admission queue."""
        eng = self.eng
        return (sum(1 for r in eng._slot_req if r is not None)
                + len(eng._queue))


class EngineRouter:
    """Least-loaded admission over N ServingEngine replicas.

    >>> router = create_router(params, cfg, family="gpt", replicas=2)
    >>> req = router.submit(prompt_ids, max_new_tokens=32)
    >>> while router.has_work():
    ...     for r, tok in router.step():
    ...         ...

    `step()` advances EVERY live replica one engine tick and returns
    the merged (request, token) emissions; `generate` wraps
    submit+drain like the engine's. Greedy streams are bit-identical
    to a single engine serving the same request (engine streams are
    slot/batch-invariant, and replicas share params + seed); sampled
    streams are reproducible per (replica, submission order) but not
    router-placement-invariant — the engine folds ITS request id into
    the PRNG stream."""

    def __init__(self, engines: Sequence[ServingEngine],
                 max_queue: int = 0, queue_policy: str = "reject",
                 concurrent: bool = True, tracing: bool = False,
                 clock=None, roles: Optional[Sequence[str]] = None,
                 admission=None, journal_dir: Optional[str] = None,
                 suspend_tier_bytes: int = 1 << 28):
        if not engines:
            raise ValueError("EngineRouter needs >= 1 engine replica")
        if queue_policy not in ("reject", "shed_oldest"):
            raise ValueError(f"queue_policy {queue_policy!r} "
                             "(reject|shed_oldest)")
        # prefill/decode disaggregation (docs/serving.md §Disaggregation):
        # roles aligns with `engines`; None = homogeneous "any" fleet
        # (the pre-role behavior, bit-for-bit). A role-split fleet must
        # start with both capabilities present — degradation below that
        # is handled at dispatch time (availability beats specialization)
        if roles is not None:
            roles = list(roles)
            if len(roles) != len(engines):
                raise ValueError(f"roles ({len(roles)}) must match "
                                 f"engines ({len(engines)})")
            if not any(r != "decode" for r in roles):
                raise ValueError("role split needs >= 1 prefill-capable "
                                 "replica (any|prefill)")
            if not any(r != "prefill" for r in roles):
                raise ValueError("role split needs >= 1 decode-capable "
                                 "replica (any|decode)")
        else:
            roles = ["any"] * len(engines)
        self.replicas = [_Replica(i, e, role=r)
                         for i, (e, r) in enumerate(zip(engines, roles))]
        self.max_queue = int(max_queue)       # bound on the ROUTER queue
        self.queue_policy = queue_policy
        # concurrent=True steps the single-rank replicas on threads: the
        # blocking host pull releases the GIL, so one replica's host
        # work overlaps another's device work (each engine is only ever
        # touched by its own worker a tick; all router bookkeeping stays
        # on the calling thread, so emission order is deterministic:
        # replica index, slot order)
        self.concurrent = bool(concurrent)
        self._exec = None                     # lazy, one worker/replica
        self._pending: collections.deque = collections.deque()
        self._next_id = 0
        self._ticks = 0
        # injectable clock (seconds, perf_counter-like) — deadline
        # re-scoping and dispatch-latency math read ONLY this, so
        # tests drive wall-budget trajectories deterministically
        self._clock = clock if clock is not None else time.perf_counter
        self._migrate_raise = False           # injected migrate_raise
        from ..profiler import flight_recorder
        self._flight = flight_recorder.recorder()
        # request-scoped tracing (profiler/tracing): the router mints
        # the trace at ITS submit and passes it down through engine
        # submit(_trace=), so router admission, dispatch, replica death
        # (severed subtree + replay link) and the terminal resolution
        # all land in one span tree per request
        self._tracer = None
        if tracing:
            from ..profiler import tracing as _tracing
            self._tracer = _tracing.tracer()
        # dispatch latency is a distribution (the router half of queue
        # wait) — histogram, not a last-write-wins gauge
        self._m_disp_ms = monitor.histogram("serving.router.dispatch_ms")
        self._m_live = monitor.gauge("serving.router.replicas_live")
        self._m_pending = monitor.gauge("serving.router.pending")
        self._m_requeue = monitor.counter("serving.router.requeues")
        self._m_rej = monitor.counter("serving.router.rejected")
        self._m_sub = monitor.counter("serving.router.requests_submitted")
        self._m_done = monitor.counter("serving.router.requests_completed")
        self._m_deaths = monitor.counter("serving.router.replica_deaths")
        # live-migration observables (serving.autoscale.* namespace —
        # the autoscaler adds scale_out/scale_in/replicas_target there;
        # telemetry_report groups the whole prefix into one block)
        self._m_mig = monitor.counter("serving.autoscale.migrations")
        self._m_mig_fb = monitor.counter(
            "serving.autoscale.migrate_fallbacks")
        self._m_mig_bytes = monitor.gauge(
            "serving.autoscale.migrated_pages_bytes")
        self._mig_bytes = 0                   # cumulative KV bytes moved
        # prefill->decode stream handoffs (the disaggregation seam) —
        # a subset of serving.autoscale.migrations
        self._m_handoff = monitor.counter("serving.router.handoffs")
        # ---------------------------------------- multi-tenant admission
        # admission= is an AdmissionController or a {tenant: TenantQuota}
        # dict (sugar — wrapped on the router's clock); None keeps the
        # pre-tenancy dispatch bit-for-bit (pure FCFS, no quotas, no
        # preemption)
        if admission is None or isinstance(admission,
                                           AdmissionController):
            self._admission = admission
        else:
            self._admission = AdmissionController(dict(admission),
                                                  clock=self._clock)
        # preempt-to-host parking lot: a suspended request's KV lives in
        # this LRU tier (host RAM, bounded) keyed ("suspend", outer.id);
        # everything else about it sits in _suspended as a kv-less
        # snapshot dict. A park the LRU evicts falls back to
        # requeue-replay at resume time — at-least-once, never limbo.
        self._suspend_tier = HostKVTier(int(suspend_tier_bytes))
        self._suspended: dict = {}            # id -> (outer, meta snap)
        self._resume_hold = False             # brownout level-2 latch
        self._m_susp = monitor.gauge("serving.router.suspended")
        # ------------------------------------------ crash-safe journal
        # construction RECOVERS: un-terminal admits from a previous
        # process replay through the router queue under their ORIGINAL
        # ids (the id counter seeds past the WAL's horizon, so fresh
        # and replayed ids never collide and the journal's terminal set
        # stays duplicate-free)
        self._journal = None
        self._m_replay = monitor.counter("serving.journal.replays")
        if journal_dir is not None:
            from .journal import RequestJournal
            self._journal = RequestJournal(journal_dir)
            self._next_id = self._journal.next_id
            for rec in self._journal.replayable():
                req = RouterRequest(
                    int(rec["id"]),
                    np.asarray(rec["prompt"], np.int32).reshape(-1),
                    int(rec["max_new_tokens"]),
                    float(rec["temperature"]), int(rec["top_k"]),
                    rec.get("eos_id"), None, None,
                    tenant=rec.get("tenant", "default"),
                    priority=int(rec.get("priority", 0)))
                req.t_submit = self._clock()
                req._router = self
                if self._tracer is not None:
                    req.trace = self._tracer.trace(
                        f"request-r{req.id}", request_id=req.id,
                        prompt_len=int(req.prompt.shape[0]),
                        max_new_tokens=req.max_new_tokens,
                        router=True, replayed=True)
                self._pending.append(req)
                self._m_replay.add()
                self._m_sub.add()
            self._m_pending.set(len(self._pending))
        self._m_live.set(len(self.replicas))

    # ------------------------------------------------------- observables
    def live(self) -> List[_Replica]:
        """Replicas still being STEPPED (includes draining ones — they
        keep serving their in-flight requests until released)."""
        return [r for r in self.replicas if r.alive]

    def dispatchable(self) -> List[_Replica]:
        """Replicas that admit NEW work: live and not draining — the
        placement set for dispatch and migration targets."""
        return [r for r in self.replicas if r.alive and not r.draining]

    def prefill_targets(self) -> List[_Replica]:
        """Dispatchable replicas whose role admits NEW requests
        (prefill-capable). Falls back to the FULL dispatchable set when
        the role split has degraded to zero prefill-capable replicas —
        role purity is a latency preference, never an availability
        constraint (the prefill_role_death drill pins this)."""
        caps = [r for r in self.dispatchable() if r.can_prefill]
        return caps if caps else self.dispatchable()

    def decode_targets(self) -> List[_Replica]:
        """Dispatchable replicas whose role holds mid-decode streams —
        migration/handoff placement. Same availability fallback as
        prefill_targets."""
        caps = [r for r in self.dispatchable() if r.can_decode]
        return caps if caps else self.dispatchable()

    def has_work(self) -> bool:
        return (bool(self._pending) or bool(self._suspended)
                or any(r.eng.has_work() for r in self.live()))

    def stats(self) -> dict:
        """Host-side router observable: per-replica liveness/load and
        the admission balance (dispatch counts)."""
        out = {"replicas": len(self.replicas),
                "replicas_live": len(self.live()),
                "replicas_dispatchable": len(self.dispatchable()),
                "pending": len(self._pending),
                "suspended": len(self._suspended),
                "requeues": self._m_requeue.value,
                "migrations": self._m_mig.value,
                "handoffs": self._m_handoff.value,
                "per_replica": [
                    {"idx": r.idx, "alive": r.alive,
                     "draining": r.draining, "role": r.role,
                     "load": r.load() if r.alive else 0,
                     "dispatched": r.m_disp.value}
                    for r in self.replicas]}
        if self._admission is not None:
            out["admission"] = self._admission.stats()
        if self._journal is not None:
            out["journal"] = {
                "admits": len(self._journal.admits),
                "ends": len(self._journal.ends),
                "replayable": len(self._journal.replayable())}
        return out

    # --------------------------------------------------------- admission
    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               deadline_ticks: Optional[int] = None,
               tenant: str = "default",
               priority: int = 0) -> RouterRequest:
        """Queue one request with the least-loaded live replica (falling
        through replicas that refuse admission); raises
        BackpressureError when every replica refuses AND the router
        queue is at max_queue under "reject" (shed_oldest evicts the
        oldest router-queued request instead). PoolExhaustedError
        propagates only when NO live replica could EVER hold the
        request. Under `admission=`, `tenant`'s token bucket is charged
        the worst-case cost first (QuotaExceededError carries the exact
        retry-after; nothing is deducted on reject), and a `priority`-
        class request that finds no capacity SUSPENDS the lowest
        strictly-lower-priority mid-decode victim to the host tier and
        takes its slot. Under `journal_dir=`, acceptance is durable
        (the admit record is fsynced before this returns) and every
        rejection leaves an end-only journal record."""
        if not self.live():
            raise BackpressureError("no live replicas", queue_depth=0)
        req = RouterRequest(self._next_id,
                            np.asarray(prompt, np.int32).reshape(-1),
                            int(max_new_tokens), float(temperature),
                            int(top_k), eos_id,
                            None if deadline_s is None
                            else float(deadline_s),
                            None if deadline_ticks is None
                            else int(deadline_ticks),
                            tenant=tenant, priority=priority)
        self._next_id += 1
        req.t_submit = self._clock()
        req._tick_submit = self._ticks
        req._router = self
        if self._tracer is not None:
            req.trace = self._tracer.trace(
                f"request-r{req.id}", request_id=req.id,
                prompt_len=int(req.prompt.shape[0]),
                max_new_tokens=req.max_new_tokens, router=True)
        # requests_submitted counts ACCEPTED requests only (same as the
        # engine's: a reject raises before anything is admitted), so
        # submitted - completed is a true in-flight gauge. EVERY reject
        # path below runs _reject first: the freshly-minted trace
        # finishes ("rejected") before raising — or the open root span
        # would leak in the tracer forever (Tracer._open is unbounded)
        # — and the journal gets its end-only record (the satellite
        # trace-leak contract: one terminal trace + one journal
        # terminal per rejection, THEN the error propagates).
        if self._admission is not None:
            cost = int(req.prompt.shape[0]) + req.max_new_tokens
            try:
                self._admission.charge(req.tenant, cost)
            except QuotaExceededError:
                self._admission.counter("rejected", req.tenant).add()
                self._m_rej.add()
                self._reject(req)
                raise
        if self._admission is not None and not self._has_free_slot():
            # preempt-to-host: no replica can SLOT this request right
            # now (engines with unbounded queues never refuse — they
            # would just queue it behind the very streams it outranks),
            # so park the lowest strictly-lower-priority mid-decode
            # victim (KV to the host tier, zero re-prefill on resume)
            # and let the dispatch below take the freed slot
            victim = self._admission.preempt_candidate(
                self._inflight(), req.priority)
            if victim is not None and self._suspend(victim):
                self._admission._m_pre.add()
        try:
            placed = self._try_dispatch(req)
        except PoolExhaustedError:
            self._reject(req)
            raise
        if placed:
            self._accept(req)
            return req
        if self.max_queue > 0 and len(self._pending) >= self.max_queue:
            if self.queue_policy == "shed_oldest":
                self._finish(self._pending.popleft(), "evicted")
            else:
                self._m_rej.add()
                self._reject(req)
                raise BackpressureError(
                    f"router queue full ({len(self._pending)} waiting, "
                    f"max_queue={self.max_queue})",
                    queue_depth=len(self._pending))
        self._pending.append(req)
        self._m_pending.set(len(self._pending))
        self._accept(req)
        return req

    def _accept(self, req: RouterRequest) -> None:
        """The accepted-submission bookkeeping shared by the placed and
        queued paths: the fsynced journal admit record (acceptance is
        durable before submit() returns), the per-tenant admitted
        counter, the submitted counter."""
        if self._journal is not None:
            self._journal.record_admit(
                req.id, [int(t) for t in req.prompt],
                req.max_new_tokens, req.temperature, req.top_k,
                req.eos_id, req.tenant, req.priority)
        if self._admission is not None:
            self._admission.counter("admitted", req.tenant).add()
        self._m_sub.add()

    def _reject(self, req: RouterRequest) -> None:
        """The rejected-submission bookkeeping run BEFORE the error
        propagates: exactly one terminal trace span and one end-only
        journal record (recovery ignores end-only ids — a rejection was
        client-visible as an exception and must never replay)."""
        if req.trace is not None:
            req.trace.finish("rejected", tokens=0)
        if self._journal is not None:
            self._journal.record_terminal(req.id, "rejected", tokens=0)

    def _remaining_budget(self, req: RouterRequest):
        """Re-scope `req`'s deadlines to the budget LEFT as of now:
        wall seconds since the router submit, router ticks since the
        submit tick (router ticks double as engine ticks — every
        router step ticks every live replica once). Returns
        (deadline_s, deadline_ticks, expired)."""
        dl_s = req.deadline_s
        if dl_s is not None:
            dl_s = dl_s - (self._clock() - req.t_submit)
        dl_t = req.deadline_ticks
        if dl_t is not None:
            dl_t = dl_t - (self._ticks - req._tick_submit)
        expired = ((dl_s is not None and dl_s <= 0.0)
                   or (dl_t is not None and dl_t <= 0))
        return dl_s, dl_t, expired

    def _try_dispatch(self, req: RouterRequest) -> bool:
        """Place `req` on the least-loaded dispatchable replica that
        accepts it. Deadlines re-scope to the REMAINING budget — a
        request whose budget is already exhausted (it waited out its
        deadline in the router queue, or died with its replica at the
        deadline edge) resolves "timeout" HERE rather than being
        dispatched with a floor-clamped budget that burns a survivor
        slot for one doomed tick."""
        dl_s, dl_t, expired = self._remaining_budget(req)
        if expired:
            self._finish(req, "timeout")
            return True                   # resolved — nothing to place
        never_fits = 0
        t_disp0 = self._clock()
        # NEW requests land on prefill-capable replicas only — a
        # prefill flood then queues against the prefill pool while
        # decode replicas keep their tick cadence (ITL p99 flat)
        live = sorted(self.prefill_targets(), key=_Replica.load)
        for rep in live:
            try:
                inner = rep.eng.submit(
                    req.prompt, req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k,
                    eos_id=req.eos_id, deadline_s=dl_s,
                    deadline_ticks=dl_t, _trace=req.trace)
            except PoolExhaustedError:
                never_fits += 1
                continue
            except BackpressureError:
                continue
            rep.inner[inner.id] = req
            rep.m_disp.add()
            self._m_disp_ms.observe((self._clock() - t_disp0) * 1e3)
            req.replica = rep.idx
            req._inner = inner
            if self._admission is not None:
                # stride update: the tenant's virtual time advances by
                # the work it just got placed, over its weight
                self._admission.note_dispatch(
                    req.tenant,
                    int(req.prompt.shape[0]) + req.max_new_tokens)
            if req.trace is not None:
                req.trace.instant("dispatch", replica=rep.idx,
                                  attempt=req.trace.attempt)
            return True
        if never_fits and never_fits == len(live):
            raise PoolExhaustedError(
                "request exceeds every live replica's page pool")
        return False

    # --------------------------------------------------------- the tick
    def step(self):
        """One router tick: dispatch what fits, advance every live
        replica one engine tick, merge their emissions onto the outer
        requests, and translate inner terminals exactly once. A replica
        whose step ESCAPES (the engine self-heals internally — an
        escape means the replica is gone) dies here and its in-flight
        requests requeue."""
        events: List[tuple] = []
        if _FAULT_HOOK is not None:
            actions = _FAULT_HOOK(self._ticks) or {}
            if actions.pop("raise_migrate", None):
                self._migrate_raise = True    # next migration fails once
            rp = actions.pop("replica_preempt", None)
            if rp is not None:
                self.kill_replica(int(rp) % len(self.replicas),
                                  reason="preempt")
            qf = actions.pop("quota_flood", None)
            if qf is not None:
                self._inject_flood(int(qf))
        # suspended streams resume BEFORE cold admissions dispatch —
        # they are mid-flight (their tokens are owed) and their slot
        # claim predates everything in the queue
        self._resume_suspended()
        self._dispatch_pending()
        live = self.live()
        results = {}
        # tensor-parallel replicas step serially in index order: every
        # rank runs this router and their collectives must meet in one
        # order on every rank
        threaded = ([rep for rep in live if rep.eng.tp == 1]
                    if self.concurrent else [])
        if len(threaded) < 2:
            threaded = []
        futs = []
        if threaded:
            if self._exec is None:
                from concurrent.futures import ThreadPoolExecutor
                self._exec = ThreadPoolExecutor(
                    max_workers=len(self.replicas),
                    thread_name_prefix="router")
            futs = [(rep, self._exec.submit(rep.eng.step))
                    for rep in threaded]
        for rep in live:
            if rep in threaded:
                continue
            try:
                results[rep.idx] = rep.eng.step()
            except Exception as e:                 # noqa: BLE001
                results[rep.idx] = e
        for rep, fut in futs:
            try:
                results[rep.idx] = fut.result()
            except Exception as e:                 # noqa: BLE001
                results[rep.idx] = e
        for rep in live:
            res = results[rep.idx]
            if isinstance(res, BaseException):
                self.kill_replica(rep.idx, reason=f"step raised: {res}")
                continue
            for ireq, tok in res:
                outer = rep.inner.get(ireq.id)
                if outer is not None and not outer.done:
                    outer.tokens.append(int(tok))
                    events.append((outer, int(tok)))
            self._sweep_terminals(rep)
        self._sweep_handoffs()
        for rep in self.replicas:
            # graceful-drain release: a draining replica leaves the
            # rotation at the FIRST tick it holds no work — every
            # in-flight request it had has migrated out or resolved
            if (rep.alive and rep.draining and not rep.inner
                    and not rep.eng.has_work()):
                self._release_replica(rep)
        self._ticks += 1
        if not self.live():
            self.abort_pending("evicted")
        self._publish_gauges()
        return events

    def _dispatch_pending(self) -> None:
        if self._admission is not None and len(self._pending) > 1:
            # weighted-fair head-of-line: reorder the queue by
            # (priority DESC, tenant virtual-time ASC, id) — the FCFS
            # loop below then runs unchanged, so admission=None keeps
            # the pre-tenancy dispatch bit-for-bit
            self._pending = collections.deque(
                self._admission.order(self._pending))
        while self._pending:
            head = self._pending[0]
            if head.done:                     # cancelled while queued
                self._pending.popleft()
                continue
            try:
                placed = self._try_dispatch(head)
            except PoolExhaustedError:
                # a request that was queued because the one replica
                # that could hold it backpressured now fits NO live
                # replica (that replica died): resolve it terminally —
                # PoolExhaustedError escapes submit() only, never
                # step()/drain(), and no request is left in limbo
                self._pending.popleft()
                self._finish(head, "evicted")
                continue
            if not placed:
                break
            self._pending.popleft()
        self._m_pending.set(len(self._pending))

    def _sweep_terminals(self, rep: _Replica) -> None:
        """Translate inner terminal resolutions (including ones with no
        emission this tick — timeout/cancel/evict) to the outer
        requests, exactly once."""
        for iid in [iid for iid, outer in rep.inner.items()
                    if outer._inner is not None and outer._inner.done]:
            outer = rep.inner.pop(iid)
            self._finish(outer, outer._inner.finish_reason)

    def _sweep_handoffs(self) -> None:
        """Disaggregation seam: every request on a "prefill"-role
        replica that has FINISHED its chunked prefill (it holds a live
        slot and `_pf_next is None`) moves to a decode replica through
        the live-migration path — host KV snapshot, zero re-prefilled
        tokens (`serving.prefills` stays == requests submitted),
        bit-identical stream continuation. A request that cannot move
        yet (decode pool full) keeps decoding IN PLACE on the prefill
        replica and retries next tick — handoff is a latency
        optimization, never a stall."""
        for rep in self.live():
            if rep.role != "prefill" or not rep.inner:
                continue
            targets = [r for r in self.dispatchable() if r.can_decode]
            if not targets:
                return
            for outer in list(rep.inner.values()):
                inner = outer._inner
                if (outer.done or inner is None or inner.slot is None
                        or inner._pf_next is not None):
                    continue              # queued / mid-prefill / gone
                if self._migrate(outer, rep, targets=targets):
                    self._m_handoff.add()

    def _publish_gauges(self) -> None:
        self._m_live.set(len(self.live()))
        self._m_pending.set(len(self._pending))
        for rep in self.replicas:
            rep.m_depth.set(rep.load() if rep.alive else 0)

    # ------------------------------------ tenancy, suspension, brownout
    def _has_free_slot(self) -> bool:
        """Whether any prefill-capable replica could SLOT a new request
        immediately — a free slot AND an empty engine queue (anything
        already engine-queued claims the slot first)."""
        for rep in self.prefill_targets():
            eng = rep.eng
            if (not eng._queue
                    and any(r is None for r in eng._slot_req)):
                return True
        return False

    def _inflight(self) -> List[RouterRequest]:
        """Un-terminal requests currently HOLDING an engine slot on a
        live replica — the preemption candidate set (queued and
        suspended requests hold nothing worth preempting)."""
        out = []
        for rep in self.live():
            out.extend(o for o in rep.inner.values()
                       if not o.done and o._inner is not None)
        return out

    def _suspend(self, outer: RouterRequest) -> bool:
        """Park `outer` mid-decode: host KV snapshot (the migration
        seam) into the router's HostKVTier, kv-less metadata into
        `_suspended`, slot and pages freed NOW. Returns False when no
        snapshot exists (mid-prefill / already gone) — the caller picks
        another victim or gives up. A KV block bigger than the whole
        tier (put refuses) falls back to requeue-replay immediately:
        capacity still frees, delivery degrades to at-least-once."""
        inner = outer._inner
        if inner is None or outer.done:
            return False
        rep = self.replicas[outer.replica]
        try:
            snap = rep.eng.snapshot_request(inner)
        except Exception:                      # noqa: BLE001
            snap = None
        if snap is None:
            return False
        kv_k = snap.pop("kv_k")
        kv_v = snap.pop("kv_v")
        rep.eng.detach_request(inner)
        rep.inner.pop(inner.id, None)
        outer._inner = None
        outer.replica = None
        if self._suspend_tier.put(("suspend", outer.id), kv_k, kv_v):
            outer.suspended = True
            self._suspended[outer.id] = (outer, snap)
            if self._admission is not None:
                self._admission.counter("suspended", outer.tenant).add()
            if outer.trace is not None:
                outer.trace.instant(
                    "suspend", kv_bytes=int(snap.get("kv_bytes", 0)))
            self._flight.note(router_suspend=outer.id,
                              priority=outer.priority,
                              tenant=outer.tenant, tick=self._ticks)
        else:
            self._replay_requeue(outer, "suspend_spill")
        self._m_susp.set(len(self._suspended))
        return True

    def _resume_suspended(self) -> int:
        """Un-park suspended streams onto replicas with capacity (id
        order — longest-parked first), restoring through the SAME seam
        migration uses: zero re-prefilled tokens, bit-identical greedy
        continuation. Held entirely while the brownout latch
        (`set_resume_hold(True)`) is on. A park whose KV the tier
        LRU-evicted replays from scratch instead; an expired budget
        resolves "timeout". Stops at the first no-capacity miss (the
        rest retry next tick). Returns the number resumed."""
        if self._resume_hold or not self._suspended:
            return 0
        resumed = 0
        for rid in sorted(self._suspended):
            outer, meta = self._suspended[rid]
            if outer.done:                     # finished while parked
                self._suspended.pop(rid, None)
                self._suspend_tier.pop(("suspend", rid))
                continue
            dl_s, dl_t, expired = self._remaining_budget(outer)
            if expired:
                self._finish(outer, "timeout")  # drops the park
                continue
            pair = self._suspend_tier.get(("suspend", rid))
            if pair is None:
                # the tier evicted this park to make room for a later
                # one: replay from scratch (at-least-once, never limbo)
                self._suspended.pop(rid, None)
                outer.suspended = False
                self._replay_requeue(outer, "suspend_evicted")
                continue
            snap = dict(meta)
            snap["kv_k"], snap["kv_v"] = pair
            placed = None
            for dst in sorted(self.decode_targets(), key=_Replica.load):
                try:
                    placed = dst.eng.restore_request(
                        snap, deadline_s=dl_s, deadline_ticks=dl_t,
                        _trace=outer.trace)
                except Exception:              # noqa: BLE001
                    placed = None
                if placed is not None:
                    break
            if placed is None:
                break                          # no capacity this tick
            self._suspended.pop(rid, None)
            self._suspend_tier.pop(("suspend", rid))
            outer.suspended = False
            dst.inner[placed.id] = outer
            outer._inner = placed
            outer.replica = dst.idx
            resumed += 1
            if self._admission is not None:
                self._admission._m_res.add()
            if outer.trace is not None:
                outer.trace.instant("resume", replica=dst.idx)
            self._flight.note(router_resume=rid, replica=dst.idx,
                              tick=self._ticks)
        self._m_susp.set(len(self._suspended))
        return resumed

    def _replay_requeue(self, outer: RouterRequest, why: str) -> None:
        """The shared at-least-once fallback: reset the stream (the
        final token list never duplicates), sever the trace subtree,
        requeue at the head of the router queue."""
        outer.tokens.clear()
        outer._inner = None
        outer.replica = None
        outer.suspended = False
        outer.requeues += 1
        self._m_requeue.add()
        if outer.trace is not None:
            outer.trace.sever(why)
            outer.trace.link_replay(cause=why)
        self._pending.appendleft(outer)
        self._m_pending.set(len(self._pending))

    def suspend_lowest_class(self) -> int:
        """Brownout level-2 action: suspend EVERY mid-decode stream of
        the lowest priority class present — but only when more than one
        class is in flight (suspending the only class serves no one).
        Returns the number suspended."""
        infl = self._inflight()
        prios = {int(o.priority) for o in infl}
        if len(prios) < 2:
            return 0
        low = min(prios)
        n = 0
        for outer in [o for o in infl if int(o.priority) == low]:
            if self._suspend(outer):
                n += 1
        return n

    def shed_oldest_pending(self, n: int = 1) -> int:
        """Brownout level-3 action: resolve the `n` oldest router-
        queued requests "evicted" (terminal — the journal and trace
        close, never limbo). Returns the number shed."""
        shed = 0
        while self._pending and shed < n:
            self._finish(self._pending.popleft(), "evicted")
            shed += 1
        self._m_pending.set(len(self._pending))
        return shed

    def set_spec_drafts(self, enabled: bool) -> bool:
        """Broadcast the speculative-drafts toggle to every live
        replica (ServingEngine.set_spec_drafts — a no-op on engines
        built without spec). Returns True when any replica now runs
        drafts."""
        on = False
        for rep in self.live():
            if rep.eng.set_spec_drafts(enabled):
                on = True
        return on

    def set_resume_hold(self, on: bool) -> None:
        """Latch (or release) suspended-stream resumption — the
        brownout level-2 hold: while on, parked streams stay parked
        even when slots free; releasing lets the per-tick resume pass
        drain the parking lot level by level."""
        self._resume_hold = bool(on)

    def _inject_flood(self, n: int) -> None:
        """testing/faults.py `quota_flood@T:N` action: burst `n` small
        priority-(-1) submissions from the "flood" tenant, swallowing
        the quota/backpressure rejects — the drill asserts OTHER
        tenants' admission and latency hold."""
        for _ in range(int(n)):
            try:
                self.submit([1, 2, 3], 4, tenant="flood", priority=-1)
            except (QuotaExceededError, BackpressureError,
                    PoolExhaustedError):
                pass

    def close(self) -> None:
        """Release host-side resources (the journal's WAL handle, the
        step executor). The engines and their device state are
        untouched — close() is for process teardown, not teardown of
        serving."""
        if self._journal is not None:
            self._journal.close()
        if self._exec is not None:
            self._exec.shutdown(wait=False)
            self._exec = None

    # ------------------------------------------------------ terminality
    def _finish(self, req: RouterRequest, reason: str) -> None:
        if req.done:
            return
        req.done = True
        req.finish_reason = reason
        req._inner = None
        if req.suspended:
            # a parked request resolving terminally (timeout / abort /
            # cancel) drops its host-tier KV — never a leak, never limbo
            self._suspended.pop(req.id, None)
            self._suspend_tier.pop(("suspend", req.id))
            req.suspended = False
        if self._journal is not None:
            # the journal's terminal set mirrors THIS seam — exactly
            # once per id per process, and recovery skips already-ended
            # ids, so it stays duplicate-free across a crash
            self._journal.record_terminal(req.id, reason,
                                          tokens=len(req.tokens))
        if req.trace is not None:
            # exactly-once terminal span: an inner engine _finish that
            # already emitted it makes this a no-op (the once-only
            # flag); router-side terminals (requeue-then-abort, cancel
            # while pending) emit here
            req.trace.finish(reason, tokens=len(req.tokens))
        self._m_done.add()

    def cancel(self, req: RouterRequest) -> bool:
        """Resolve `req` with finish_reason "cancelled" right now.
        Returns False when it already resolved."""
        if req.done:
            return False
        if req._inner is not None:
            rep = self.replicas[req.replica]
            rep.inner.pop(req._inner.id, None)
            if rep.alive:
                req._inner.cancel()       # frees the engine slot
        elif not req.suspended:           # parked: _finish drops the KV
            try:
                self._pending.remove(req)
            except ValueError:
                pass
            self._m_pending.set(len(self._pending))
        self._finish(req, "cancelled")
        return True

    def abort_pending(self, reason: str = "evicted") -> int:
        """Resolve EVERY live request (router-queued and on-replica)
        with the terminal `reason` — no request in limbo. Returns the
        number aborted."""
        if reason not in TERMINAL_REASONS:
            raise ValueError(f"reason {reason!r} not in "
                             f"{sorted(TERMINAL_REASONS)}")
        n = 0
        while self._pending:
            self._finish(self._pending.popleft(), reason)
            n += 1
        for rid in list(self._suspended):
            outer, _ = self._suspended[rid]
            if not outer.done:
                self._finish(outer, reason)   # drops the parked KV too
                n += 1
            else:                             # stale park: just drop it
                self._suspended.pop(rid, None)
                self._suspend_tier.pop(("suspend", rid))
        for rep in self.replicas:
            for outer in list(rep.inner.values()):
                if outer.done:
                    continue
                if rep.alive and outer._inner is not None:
                    outer._inner.cancel()
                self._finish(outer, reason)
                n += 1
            rep.inner.clear()
        self._publish_gauges()
        return n

    # ------------------------------------------------- fleet elasticity
    def spawn_replica(self, engine: ServingEngine,
                      role: str = "any") -> int:
        """Scale OUT: add a warm `engine` to the rotation (with a
        disaggregation `role`, default "any") and return its replica
        index. The engine must share params/config with the fleet
        (greedy bit-parity across replicas assumes it); the
        autoscaler's `spawn` factory owns that construction. Joins
        the dispatchable set immediately — the next `step()` places
        queued work on it. Leaves a flight-recorder dump."""
        rep = _Replica(len(self.replicas), engine, role=role)
        self.replicas.append(rep)
        if self._exec is not None:
            # the lazy executor was sized for the OLD fleet — rebuild
            # next tick so every live replica still gets its own worker
            self._exec.shutdown(wait=False)
            self._exec = None
        self._flight.note(router_spawn=rep.idx, role=role,
                          tick=self._ticks,
                          replicas_live=len(self.live()))
        self._flight.dump("router_scale_out")
        self._publish_gauges()
        return rep.idx

    def drain_replica(self, idx: int, migrate: bool = True) -> int:
        """Scale IN, gracefully: replica `idx` stops admitting new
        work but KEEPS STEPPING its in-flight requests; the router
        releases it at the first tick it holds no work. With
        `migrate=True` every snapshot-able in-flight request moves to
        a dispatchable survivor NOW (zero re-prefill, bit-identical
        continuation) so release is typically immediate; requests that
        cannot move (mid-prefill, no capacity) simply finish in place.
        Returns the number migrated. Idempotent; flight-dumps."""
        rep = self.replicas[idx]
        if not rep.alive or rep.draining:
            return 0
        rep.draining = True
        moved = 0
        if migrate:
            for outer in [o for o in rep.inner.values() if not o.done]:
                if self._migrate(outer, rep):
                    moved += 1
        self._flight.note(router_drain=idx, migrated=moved,
                          remaining=len(rep.inner), tick=self._ticks)
        self._flight.dump("router_scale_in")
        self._publish_gauges()
        return moved

    def _release_replica(self, rep: _Replica) -> None:
        """Final step of a graceful drain: the replica holds no work —
        take it out of rotation (NOT a death: nothing requeues, the
        deaths counter stays put)."""
        rep.alive = False
        rep.draining = False
        self._flight.note(router_release=rep.idx, tick=self._ticks)
        self._flight.dump("router_release")

    # ----------------------------------------------------- live migration
    def _migrate(self, outer: RouterRequest, src: _Replica,
                 targets: Optional[List[_Replica]] = None) -> bool:
        """Move `outer` mid-decode from `src` to a dispatchable
        survivor via host KV snapshot — the zero-re-prefill path.
        Order is snapshot -> restore -> detach so any failure leaves
        the source intact (the caller falls back to requeue-replay or
        leaves the request draining in place). Deadlines re-scope to
        the remaining budget; an exhausted budget resolves "timeout"
        here. Returns True only when the request now lives on the
        target replica."""
        inner = outer._inner
        if inner is None or outer.done:
            return False
        try:
            if self._migrate_raise:
                self._migrate_raise = False
                raise RuntimeError("injected migrate_raise")
            snap = src.eng.snapshot_request(inner)
        except Exception:                      # noqa: BLE001 — fault or
            snap = None                        # mid-step corpse: fallback
        if snap is None:
            self._m_mig_fb.add()
            return False
        dl_s, dl_t, expired = self._remaining_budget(outer)
        if expired:
            src.eng.detach_request(inner)
            src.inner.pop(inner.id, None)
            self._finish(outer, "timeout")
            return True                        # resolved, nothing to move
        if targets is None:
            # a migrating request is mid-decode by construction
            # (snapshot_request refuses mid-prefill), so decode-capable
            # replicas come first; prefill-role replicas remain a
            # last-resort landing zone under fleet degradation
            targets = sorted((r for r in self.dispatchable()
                              if r is not src),
                             key=lambda r: (not r.can_decode, r.load()))
        else:
            targets = sorted((r for r in targets if r is not src),
                             key=_Replica.load)
        for dst in targets:
            try:
                new_inner = dst.eng.restore_request(
                    snap, deadline_s=dl_s, deadline_ticks=dl_t,
                    _trace=outer.trace)
            except Exception:                  # noqa: BLE001
                new_inner = None
            if new_inner is None:
                continue
            src.eng.detach_request(inner)
            src.inner.pop(inner.id, None)
            dst.inner[new_inner.id] = outer
            outer._inner = new_inner
            outer.replica = dst.idx
            self._m_mig.add()
            self._mig_bytes += int(snap.get("kv_bytes", 0))
            self._m_mig_bytes.set(self._mig_bytes)
            if outer.trace is not None:
                outer.trace.instant("migrate", src=src.idx, dst=dst.idx,
                                    kv_bytes=int(snap.get("kv_bytes", 0)))
            self._flight.note(router_migration=outer.id, src=src.idx,
                              dst=dst.idx, tick=self._ticks,
                              kv_bytes=int(snap.get("kv_bytes", 0)))
            return True
        self._m_mig_fb.add()                   # snapshot ok, no capacity
        return False

    # ---------------------------------------------------- replica death
    def kill_replica(self, idx: int, reason: str = "killed",
                     migrate: bool = True) -> int:
        """Take replica `idx` out of rotation NOW. Un-terminal requests
        it held migrate to a survivor via live KV snapshot when
        possible (`migrate=True`, zero re-prefill, bit-identical
        continuation); the rest requeue at the HEAD of the router
        queue (they waited longest) and replay from scratch — their
        token lists reset so the final streams carry no duplicates.
        Already-terminal requests stay resolved (exactly-once).
        Returns the number requeued for replay. Idempotent; leaves a
        flight-recorder dump."""
        rep = self.replicas[idx]
        if not rep.alive:
            return 0
        rep.alive = False
        rep.draining = False
        self._m_deaths.add()
        victims = [o for o in rep.inner.values() if not o.done]
        replay = []
        migrated = 0
        for outer in victims:
            # migration-first: reads the dying engine's arrays, which
            # survive `alive=False` (host process, not real hardware
            # loss) — a replica killed because its STEP raised usually
            # fails the snapshot instead and takes the replay path
            if migrate and self._migrate(outer, rep):
                migrated += 1
            elif not outer.done:               # _migrate may resolve it
                replay.append(outer)
        rep.inner.clear()
        for outer in replay:
            outer.tokens.clear()          # replay regenerates the stream
            outer._inner = None
            outer.replica = None
            outer.requeues += 1
            self._m_requeue.add()
            if outer.trace is not None:
                # close the dead replica's span subtree (tagged
                # severed, trace NOT finished) and link the replay
                # attempt — the survivor's spans carry the bumped
                # attempt index
                outer.trace.sever("replica_death", replica=idx)
                outer.trace.link_replay(replica_died=idx)
        self._pending.extendleft(reversed(replay))
        self._flight.note(router_replica_death=idx, reason=reason,
                          migrated=migrated, requeued=len(replay),
                          tick=self._ticks)
        self._flight.dump("router_replica_death")
        if not self.live():
            self.abort_pending("evicted")
        self._publish_gauges()
        return len(replay)

    # ------------------------------------------------------ conveniences
    def drain(self, max_ticks: Optional[int] = None):
        events = []
        ticks = 0
        while self.has_work():
            events.extend(self.step())
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        return events

    def generate(self, prompts: Sequence, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 deadline_ticks: Optional[int] = None,
                 max_ticks: Optional[int] = None) -> List[np.ndarray]:
        """Batch convenience mirroring ServingEngine.generate: submit
        every prompt, drain, resolve stragglers ("evicted" — never
        limbo), return each request's generated ids in order."""
        reqs = [self.submit(p, max_new_tokens, temperature=temperature,
                            top_k=top_k, eos_id=eos_id,
                            deadline_s=deadline_s,
                            deadline_ticks=deadline_ticks)
                for p in prompts]
        self.drain(max_ticks)
        for r in reqs:
            if not r.done:
                self.cancel(r)
                r.finish_reason = "evicted"
        return [np.asarray(r.tokens, np.int32) for r in reqs]


def create_router(params, cfg, replicas: int = 2, family: str = "gpt",
                  max_queue: int = 0, queue_policy: str = "reject",
                  concurrent: bool = True,
                  meshes: Optional[Sequence] = None,
                  tracing: bool = False, clock=None,
                  roles: Optional[Sequence[str]] = None,
                  admission=None, journal_dir: Optional[str] = None,
                  **engine_kw) -> EngineRouter:
    """Build an EngineRouter over `replicas` identical ServingEngines
    sharing ONE param tree (read-only at decode — on a single host the
    replicas share the arrays; in a real deployment each replica's
    params live on its own devices). `meshes` optionally gives each
    replica its own tensor-parallel mesh (inference/serving.py mesh=)
    — the dp(router) x tp(engine) composition. `tracing` turns on
    request-scoped tracing at the ROUTER (the engines inherit the
    trace through dispatch — they need no tracer of their own). A
    `telemetry_jsonl=` engine kwarg fans out per replica
    (`<path>.r<i>`), so each replica streams its own serving_tick
    JSONL — the per-replica files tools/telemetry_report.py's fleet
    mode merges. `roles` (aligned with replica index, values
    any|prefill|decode) turns on prefill/decode disaggregation —
    docs/serving.md §Disaggregation. `admission` (an
    AdmissionController or a {tenant: TenantQuota} dict) turns on
    multi-tenant quotas / weighted-fair dispatch / preempt-to-host;
    `journal_dir` turns on the crash-safe request WAL (construction
    over an existing directory RECOVERS and replays) — docs/serving.md
    §Tenancy, brownout & durability."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1; got {replicas}")
    if meshes is not None and len(meshes) != replicas:
        raise ValueError(f"meshes ({len(meshes)}) must match "
                         f"replicas ({replicas})")
    tele = engine_kw.pop("telemetry_jsonl", None)
    engines = [ServingEngine(params, cfg, family=family,
                             mesh=None if meshes is None else meshes[i],
                             telemetry_jsonl=(f"{tele}.r{i}" if tele
                                              else None),
                             **engine_kw)
               for i in range(replicas)]
    return EngineRouter(engines, max_queue=max_queue,
                        queue_policy=queue_policy, concurrent=concurrent,
                        tracing=tracing, clock=clock, roles=roles,
                        admission=admission, journal_dir=journal_dir)
