"""Host-tier KV: spill cold prefix pages to host RAM, swap them back on a
hit.

Counterpart of paddle_tpu/inference/host_kv.py (the port keeps its own
copy). The device pool's LRU cache (serving._PagePool) is the hot tier;
this is the warm tier behind it: when `alloc()` evicts a registered page
(a prompt-prefix page a later request could hit), the engine's
`on_evict` tap copies the page's K/V here before the prefix entry drops.
Admission's prefix walk consults the device first and the host second;
a host hit swaps the page back in (one in-place page copy) instead of
prefilling those tokens again, so the prefix cache's capacity is bounded
by this tier's byte cap, not by device memory.

Correctness leans on copy-on-write: a registered page's content is
immutable (writers copy it first), so the host copy taken at eviction is
bit-equal to what a device hit would read. Dropping an entry from this
tier (its own LRU over the byte cap) is safe too: the key prefills again
later.

Pages are CPU tensors [L, page_size, heads, hd] in the cache dtype,
pinned when the engine runs on the card, so a swap-in upload can run
asynchronously and overlap the wait at admission.

Accounting: ServingEngine.memory_ledger() prices the tier as
`kv_pool_host`, outside the device total. Kill switch: an off value of
PADDLE_TPU_HOST_KV zeroes the cap even for engines built with
host_kv_bytes > 0.
"""
from __future__ import annotations

import collections
import os
import sys

import torch

__all__ = ["ENV_HOST_KV", "HostKVTier", "resolve_host_kv"]

ENV_HOST_KV = "PADDLE_TPU_HOST_KV"

_OFF_VALUES = frozenset({"0", "off", "false", "no"})


def resolve_host_kv(knob: int = 0) -> int:
    """The engine's host_kv_bytes knob resolved to a byte cap (0: tier
    off). The env var kill-switches an explicit cap and can set one for
    knob-0 engines (an int byte count); an unrecognized value fails safe
    to off with a stderr warning."""
    cap = int(knob or 0)
    if cap < 0:
        raise ValueError(f"host_kv_bytes must be >= 0; got {knob}")
    env = os.environ.get(ENV_HOST_KV, "").strip().lower()
    if not env:
        return cap
    if env in _OFF_VALUES:
        return 0
    try:
        n = int(env)
    except ValueError:
        n = -1
    if n >= 0:
        return n if cap == 0 else cap
    print(f"[host_kv] {ENV_HOST_KV}={env!r} is not a byte count or one "
          f"of {sorted(_OFF_VALUES)}; treating as 'off' (the kill "
          "switch fails safe)", file=sys.stderr, flush=True)
    return 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class HostKVTier:
    """LRU map of prompt-prefix key -> (k, v) host tensors, one page
    each. `put` copies (the caller hands a view of the device pool);
    `get` touches LRU order; an insert evicts this tier's own LRU entries
    past `max_bytes`. Single-threaded, as the engine that owns it."""

    def __init__(self, max_bytes: int, pin: bool = False):
        self.max_bytes = int(max_bytes)
        self.pin = bool(pin)
        self._d: "collections.OrderedDict[object, tuple]" = \
            collections.OrderedDict()
        self.bytes = 0
        self.spills = 0      # pages demoted device -> host (lifetime)
        self.swapins = 0     # pages promoted host -> device (lifetime)
        self.drops = 0       # pages this tier itself evicted (lifetime)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def _host_copy(self, t) -> torch.Tensor:
        t = torch.as_tensor(t)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pin)
        out.copy_(t)
        return out

    def put(self, key, k, v) -> bool:
        if key in self._d:
            self._d.move_to_end(key)
            return False
        cost = _nbytes(torch.as_tensor(k)) + _nbytes(torch.as_tensor(v))
        if cost > self.max_bytes:
            return False                 # a page bigger than the tier
        while self.bytes + cost > self.max_bytes and self._d:
            _, (ek, ev) = self._d.popitem(last=False)    # the tier's LRU
            self.bytes -= _nbytes(ek) + _nbytes(ev)
            self.drops += 1
        self._d[key] = (self._host_copy(k), self._host_copy(v))
        self.bytes += cost
        self.spills += 1
        return True

    def get(self, key):
        """(k, v) host pair or None; a hit refreshes LRU order. The entry
        stays after a swap-in: the content is immutable under COW, so the
        copy is still valid if the device pool evicts the page again."""
        pair = self._d.get(key)
        if pair is not None:
            self._d.move_to_end(key)
        return pair

    def pop(self, key) -> None:
        """Drop `key`'s pair (a parked request the router resumed or
        resolved)."""
        pair = self._d.pop(key, None)
        if pair is not None:
            self.bytes -= _nbytes(pair[0]) + _nbytes(pair[1])

    def stats(self) -> dict:
        return {"entries": len(self._d), "bytes": self.bytes,
                "spills": self.spills, "swapins": self.swapins,
                "drops": self.drops}
