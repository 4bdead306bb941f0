"""Multi-tenant admission control for the serving router: per-tenant
token-bucket quotas, priority classes, and weighted-fair dispatch order.

Counterpart of paddle_tpu/inference/admission.py (the port keeps its own
copy). Three mechanisms, all host arithmetic (no device work, no pull):

- **Token-bucket quotas** (`TenantQuota.tokens_per_s` / `burst`): each
  submit charges its worst-case token cost (prompt + max_new_tokens). An
  empty bucket raises `QuotaExceededError` carrying the exact
  `retry_after_s` refill wait. rate <= 0 means unmetered (the default
  tenant).
- **Weighted-fair ordering** (`order()`): the router's pending queue
  dispatches by (priority DESC, tenant virtual time ASC, id): stride
  scheduling, each tenant's virtual time advancing by its dispatched
  tokens over its weight, so a flooding tenant cannot starve a light one
  at equal priority, and priority classes strictly dominate.
- **Preemption policy**: `preempt_candidate()` picks the lowest-priority
  mid-decode victim strictly below an arriving request's class; the
  router suspends it (its KV parks in a host tier through
  `ServingEngine.snapshot_request`) and resumes it later with zero
  re-prefilled tokens.

The controller never touches replicas or engines: the router asks it
three questions (may this admit? in what order? who yields?) and owns
every state transition, so exactly-once terminal resolution stays in
one place (inference/router.py `_finish`).

Observables: per-tenant serving.admission.{admitted,rejected,
suspended}.<tenant> counters and serving.admission.{preemptions,
resumes}; the clock is injectable, so tests drive refills exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from ..profiler import monitor

__all__ = ["TenantQuota", "QuotaExceededError", "AdmissionController"]


class QuotaExceededError(RuntimeError):
    """A tenant's token bucket cannot cover the request's worst-case
    token cost. `retry_after_s` is the exact refill wait until THIS
    request would admit — the client-visible backoff budget."""

    def __init__(self, msg: str, tenant: str = "",
                 retry_after_s: float = 0.0, tokens_requested: int = 0,
                 tokens_available: float = 0.0):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        self.tokens_requested = int(tokens_requested)
        self.tokens_available = float(tokens_available)


@dataclasses.dataclass
class TenantQuota:
    """One tenant's admission envelope. `tokens_per_s <= 0` = no rate
    limit (the bucket never empties); `burst` caps the bucket (how much
    a quiet tenant can bank); `weight` scales fair-share dispatch (a
    weight-2 tenant drains its backlog twice as fast as a weight-1 one
    at equal priority)."""
    tokens_per_s: float = 0.0
    burst: float = 0.0
    weight: float = 1.0

    def __post_init__(self):
        if self.tokens_per_s > 0 and self.burst <= 0:
            raise ValueError(
                f"a rate-limited tenant needs burst > 0; got "
                f"tokens_per_s={self.tokens_per_s}, burst={self.burst}")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0; got {self.weight}")


class _Bucket:
    __slots__ = ("level", "last", "vtime")

    def __init__(self, burst: float, now: float):
        self.level = float(burst)   # tokens available
        self.last = now             # last refill timestamp
        self.vtime = 0.0            # stride-scheduling virtual time


class AdmissionController:
    """Quota + fairness + preemption policy for EngineRouter. Tenants
    not named in `quotas` get `default` (unmetered, weight 1 unless
    overridden). Single-threaded with the router that owns it."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 default: Optional[TenantQuota] = None, clock=None):
        self.quotas = dict(quotas or {})
        self.default = default or TenantQuota()
        self._clock = clock if clock is not None else time.perf_counter
        self._b: Dict[str, _Bucket] = {}
        self._m_pre = monitor.counter("serving.admission.preemptions")
        self._m_res = monitor.counter("serving.admission.resumes")
        self._per: Dict[tuple, object] = {}

    # --------------------------------------------------------- plumbing
    def quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default)

    def _bucket(self, tenant: str) -> _Bucket:
        b = self._b.get(tenant)
        if b is None:
            b = self._b[tenant] = _Bucket(self.quota(tenant).burst,
                                          self._clock())
        return b

    def counter(self, kind: str, tenant: str):
        """Lazily-minted per-tenant counter
        (serving.admission.<kind>.<tenant> — the dynamic-suffix family
        telemetry_report's admission block groups)."""
        key = (kind, tenant)
        c = self._per.get(key)
        if c is None:
            c = self._per[key] = monitor.counter(
                f"serving.admission.{kind}.{tenant}")
        return c

    # ------------------------------------------------------------ quota
    def charge(self, tenant: str, tokens: int) -> None:
        """Deduct `tokens` from the tenant's bucket, refilled to now.
        Raises QuotaExceededError (with the exact retry-after) when the
        bucket cannot cover it — nothing is deducted then, so a
        rejected request never burns budget."""
        q = self.quota(tenant)
        if q.tokens_per_s <= 0:
            return
        b = self._bucket(tenant)
        now = self._clock()
        b.level = min(q.burst, b.level + (now - b.last) * q.tokens_per_s)
        b.last = now
        if tokens > b.level:
            retry = (tokens - b.level) / q.tokens_per_s
            raise QuotaExceededError(
                f"tenant {tenant!r} quota exceeded: request costs "
                f"{tokens} tokens, {b.level:.1f} available "
                f"(rate {q.tokens_per_s}/s); retry in {retry:.2f}s",
                tenant=tenant, retry_after_s=retry,
                tokens_requested=tokens, tokens_available=b.level)
        b.level -= tokens

    # --------------------------------------------------------- fairness
    def note_dispatch(self, tenant: str, tokens: int) -> None:
        """Advance the tenant's virtual time by its served work over
        its weight — the stride-scheduling update `order()` reads."""
        self._bucket(tenant).vtime += tokens / self.quota(tenant).weight

    def order(self, pending) -> list:
        """The weighted-fair dispatch order over router-pending
        requests: priority classes strictly first (higher number =
        more urgent), then each tenant's virtual time (least-served
        first), then submission id (FIFO within a tenant). Pure
        reorder — no request is dropped or charged here."""
        return sorted(
            pending,
            key=lambda r: (-int(getattr(r, "priority", 0)),
                           self._bucket(getattr(r, "tenant",
                                                "default")).vtime,
                           r.id))

    # ------------------------------------------------------- preemption
    def preempt_candidate(self, inflight, priority: int):
        """The suspension victim for an arriving `priority`-class
        request: the LOWEST-priority mid-decode request STRICTLY below
        it (ties broken toward the most recently submitted — it has
        the least sunk work to park). None when nothing yields —
        preemption never inverts or equalizes priorities."""
        cands = [r for r in inflight
                 if not r.done and int(getattr(r, "priority", 0))
                 < int(priority)]
        if not cands:
            return None
        return min(cands, key=lambda r: (int(getattr(r, "priority", 0)),
                                         -r.id))

    def stats(self) -> dict:
        now = self._clock()
        out = {}
        for t, b in self._b.items():
            q = self.quota(t)
            level = (b.level if q.tokens_per_s <= 0 else
                     min(q.burst, b.level + (now - b.last)
                         * q.tokens_per_s))
            out[t] = {"tokens_available": round(level, 1),
                      "vtime": round(b.vtime, 3),
                      "weight": q.weight,
                      "tokens_per_s": q.tokens_per_s}
        return out
