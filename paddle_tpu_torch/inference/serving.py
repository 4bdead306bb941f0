"""Continuous-batching serving engine: a dense slot-pool or paged KV
cache, bucketed or chunked prefill, one decode tick for all slots,
speculative decode, K ticks a dispatch, and a host KV tier.

Counterpart of paddle_tpu/inference/serving.py (the dense and paged
layouts, prefix sharing, chunked prefill, speculative decode,
multi-tick decode, the host KV tier).
Reference analog: AnalysisPredictor driving the FusedMultiTransformer
decode loops, generalized to iteration-level scheduling (Orca-style
continuous batching): requests join and leave the running batch between
decode ticks.

- **Slot pool.** N decode slots backed by one stacked KV cache
  {"k","v": [L, N, max_len, heads, hd]} on the device, written in place:
  GPT caches its H heads, Llama its KV heads.
- **One decode tick.** Every tick advances all N slots one token: the
  per-row-position cached forward runs the N current tokens as one
  batch, and greedy or temperature/top-k sampling happens on the device.
  The slot state (current token, position, active, temperature, top-k,
  request id, token index) lives on the device and is re-uploaded from
  the host mirrors only when admission or a finish changes it. The host
  pulls ONE small array per tick: the sampled tokens.
- **Bucketed prefill.** A prompt pads to its power-of-two bucket
  (models/decode.prompt_bucket) and runs through a fresh one-row cache
  of that length; the first token comes from the logits at the true
  length - 1 and the mini cache is copied into the slot's row. This is
  what makes engine streams identical to per-request greedy decode.
- **Paged layout** (kv_layout="paged"; vLLM's PagedAttention block
  manager, SGLang's prefix cache). K/V live in a page pool
  {"k","v": [L, P, page_size, heads, hd], "pt": [N, max_pages]} and a
  host allocator (`_PagePool`) hands out pages: free, live (refcount >
  0) or cached (refcount 0 but registered under a prompt-prefix hash,
  LRU-evictable). Page 0 is scratch. A prompt's full pages are
  registered after its prefill; a later prompt with the same prefix
  maps them (prefix sharing) and prefills only its suffix; writing a
  shared or registered page copies it first (copy-on-write,
  `_ensure_private`). Admission reserves the request's worst-case page
  need, so decode never runs out of pages; a request that could never
  fit raises PoolExhaustedError at submit, one that must wait stays
  queued. A suffix longer than `prefill_chunk` prefills one chunk per
  tick, interleaved with the decode ticks. The streams are those of
  the dense layout: the gathered view puts position p at index p.
- **Speculative decode** (spec_decode="spec"; inference/spec_decode.py):
  each tick drafts `gamma` tokens through the first `draft_layers`
  layers and verifies them in one full-depth pass; greedy streams are
  the non-spec streams, and the host still pulls one array a tick.
- **Multi-tick decode** (multi_tick=K; inference/multi_tick.py): a
  dispatch runs K ticks (K spec rounds under spec decode) and the host
  pulls one [N, K] emission matrix, retiring slots on the device by the
  host's finish rules. On the card a dispatch is one replay of a CUDA
  graph of the K ticks, captured once per `sampling` flag over static
  buffers: the slot state, the early-exit inputs and the page table are
  copied into them, and the cache is only ever written in place, so no
  address a graph holds changes; the tensors a family's forward reads
  from a memo (Llama's RoPE tables) are held with the graph, so no
  eviction frees one. The first dispatch of each flag runs
  eagerly (its tokens are real) and is then captured; a capture or
  replay that fails raises, the engine never falls back to eager ticks.
  K = 1 is the eager single tick.
- **Host KV tier** (host_kv_bytes=B, paged with prefix sharing;
  inference/host_kv.py): a registered page the pool's LRU evicts is
  copied to host RAM first; admission's prefix walk looks on the device,
  then on the host, and swaps a host hit back into a fresh page in
  place, so prefix reuse outlives device eviction. Streams are those of
  an engine without the tier.
- **Quarantine.** With guardrails on, a row whose logits are not all
  finite folds into a -1 token on the device (real ids are never
  negative); the host finishes only that request as "poisoned".
- **Weight-only int8.** quant="int8" rewrites the params tree at build
  (quantization/serving.py); the forward picks the int8 pairs up from
  the tree and every block matmul and the head run the hand-written
  Hopper kernel (kernels/quant_matmul.py) on the card: per full pass,
  the family's quantized leaves per layer times the depth, plus the
  head (GPT 4 L + 1, Llama 7 L + 1); a spec tick adds gamma draft
  passes of draft_layers layers and the head.

Sampled streams cannot match the reference bit for bit (it draws with
threefry). The invariant is kept instead: a request's sampled stream
depends only on (seed, request id, token index), never on its slot or
on the rest of the batch. The noise is a counter-based hash of those
three values and the vocabulary index, computed on the device, and the
draw is Gumbel-max over the temperature-scaled, top-k-masked logits.

Every request resolves exactly once with a finish reason from
TERMINAL_REASONS. Engine knobs of later slices (tensor-parallel meshes,
telemetry, tracing, watchdog and retries, queue bounds) raise
NotImplementedError naming the ROADMAP item that ports them. The reference's fault-injection hooks are not carried (A7).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.decode import prompt_bucket

__all__ = ["ServingEngine", "Request", "ModelFamily", "family_for",
           "create_serving_engine", "TERMINAL_REASONS",
           "PoolExhaustedError"]

TERMINAL_REASONS = frozenset(
    {"eos", "length", "cancelled", "poisoned", "evicted"})

# device index -> the side stream every engine's multi-tick warm-ups and
# CUDA graph captures run on: cuBLAS keeps a workspace for each stream it
# has run on, so a stream per engine would leave one behind per build
_CAPTURE_STREAMS: dict = {}

# knob -> (values that leave the knob inert, the ROADMAP item porting it)
_UNPORTED = {
    "mesh": ((None,), "A6 (tensor-parallel serving)"),
    "tp_axis": (("tp",), "A6 (tensor-parallel serving)"),
    "telemetry": (("auto", "off"), "A7 (serving telemetry)"),
    "telemetry_jsonl": ((None,), "A7 (serving telemetry)"),
    "telemetry_every": ((32,), "A7 (serving telemetry)"),
    "tracing": ((False,), "A7 (request tracing)"),
    "watchdog_timeout": ((0.0,), "A7 (watchdog and retries)"),
    "retries": ((2,), "A7 (watchdog and retries)"),
    "backoff_base": ((0.05,), "A7 (watchdog and retries)"),
    "backoff_max": ((2.0,), "A7 (watchdog and retries)"),
    "max_queue": ((0,), "A7 (admission queue bounds)"),
    "queue_policy": (("reject",), "A7 (admission queue bounds)"),
    "queue_ttl_s": ((0.0,), "A7 (admission queue bounds)"),
}


def _check_unported(knobs: dict) -> None:
    for name, value in knobs.items():
        if name not in _UNPORTED:
            raise TypeError(f"ServingEngine got an unexpected keyword "
                            f"argument {name!r}")
        inert, item = _UNPORTED[name]
        if value not in inert:
            raise NotImplementedError(
                f"ServingEngine {name}={value!r} is not ported yet "
                f"(ROADMAP {item})")


class PoolExhaustedError(RuntimeError):
    """submit() refused: the request's worst-case page need exceeds the
    whole pool, so it could never be admitted. A request that merely has
    to wait for pages is queued, not refused."""

    def __init__(self, msg: str, pages_needed: int = 0,
                 pages_total: int = 0):
        super().__init__(msg)
        self.pages_needed = pages_needed
        self.pages_total = pages_total


# --------------------------------------------------------------- families
@dataclasses.dataclass(frozen=True)
class ModelFamily:
    """The seam a model family exposes to the engine: a cached forward
    that accepts per-row positions, a cache factory, and the tensors the
    forward reads beyond params and cache (a memo may free them; the
    engine keeps them alive with each CUDA graph that baked them)."""
    name: str
    forward_cached: Callable    # (params, tokens[B,T], cache, pos, cfg)
    init_cache: Callable        # (cfg, batch, max_len, device) -> {"k","v"}
    held_tensors: Callable = lambda cfg, cache: ()   # (cfg, cache) -> tuple


def family_for(name: str) -> ModelFamily:
    if name == "gpt":
        from ..models import gpt
        return ModelFamily("gpt", gpt.gpt_forward_cached, gpt.init_kv_cache)
    if name == "llama":
        from ..models import llama
        return ModelFamily("llama", llama.llama_forward_cached,
                           llama.init_kv_cache, llama.cached_rope_tables)
    raise ValueError(f"unknown model family {name!r} (gpt|llama)")


# -------------------------------------------------------------- page pool
class _PagePool:
    """Host-side allocator of the paged KV pool (the scheduler half of
    the vLLM block manager). Every page but scratch page 0 is in exactly
    one state:

    - free      unregistered, on the free list;
    - live      refcount > 0 (mapped by one or more slot tables);
    - cached    refcount 0 but registered under a prompt-prefix key (LRU,
                evicted on demand: cross-request prefix reuse).

    `reserved` counts admission reservations not yet turned into pages;
    `available()` is what a new admission may claim without starving an
    admitted slot. `on_evict(pid, key)`, when set, is called just before
    a registered page's eviction drops its prefix entry: the engine's
    host tier copies the page there."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is "
                             f"reserved scratch); got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.ref = np.zeros(num_pages, np.int64)
        self.ref[0] = 1                      # scratch: pinned forever
        # pop() takes from the end: low page ids hand out first
        self.free: List[int] = list(range(num_pages - 1, 0, -1))
        self.cached: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()        # page id -> key, LRU order
        self.by_key: dict = {}               # prefix key -> page id
        self.key_of: dict = {}               # page id -> prefix key
        self.reserved = 0
        self.on_evict: Optional[Callable] = None

    def available(self) -> int:
        """Pages a new admission may still reserve: free + evictable
        cached, less what earlier admissions reserved."""
        return len(self.free) + len(self.cached) - self.reserved

    def alloc(self) -> int:
        """One private page (ref 1), evicting the LRU cached page (and
        its prefix entry) when the free list is dry."""
        if self.free:
            pid = self.free.pop()
        elif self.cached:
            pid, key = self.cached.popitem(last=False)     # LRU
            if self.on_evict is not None:
                self.on_evict(pid, key)
            del self.by_key[key]
            del self.key_of[pid]
        else:
            raise PoolExhaustedError(
                "page pool exhausted (no free or evictable page)",
                pages_needed=1, pages_total=self.num_pages)
        self.ref[pid] = 1
        return pid

    def retain(self, pid: int) -> None:
        """One more reference (prefix sharing): a cached page comes back
        live and keeps its registration."""
        if self.ref[pid] == 0:
            self.cached.pop(pid, None)
        self.ref[pid] += 1

    def release(self, pid: int) -> None:
        """Drop one reference. At zero a registered page parks in the
        LRU cache, an unregistered one returns to the free list."""
        if pid == 0:
            return                           # scratch never releases
        self.ref[pid] -= 1
        assert self.ref[pid] >= 0, f"refcount underflow on page {pid}"
        if self.ref[pid] == 0:
            key = self.key_of.get(pid)
            if key is not None:
                self.cached[pid] = key
                self.cached.move_to_end(pid)
            else:
                self.free.append(pid)

    def register(self, pid: int, key) -> None:
        """Publish `pid` under the prompt-prefix `key` (the first writer
        wins; a racing identical prefix keeps its private copy)."""
        if key not in self.by_key and pid not in self.key_of:
            self.by_key[key] = pid
            self.key_of[pid] = key

    def lookup(self, key) -> Optional[int]:
        return self.by_key.get(key)

    def is_frozen(self, pid: int) -> bool:
        """Writing `pid` needs a private copy first: shared (ref > 1) or
        published in the prefix map."""
        return self.ref[pid] > 1 or pid in self.key_of

    def stats(self) -> dict:
        return {"num_pages": self.num_pages,
                "page_size": self.page_size,
                "pages_in_use": int((self.ref[1:] > 0).sum()),
                "pages_free": len(self.free),
                "pages_cached": len(self.cached),
                "pages_shared": int((self.ref[1:] > 1).sum()),
                "pages_reserved": int(self.reserved)}


def _prefix_key(prompt: np.ndarray, n: int) -> tuple:
    """The rolled prompt-prefix hash of the page ending at token `n`:
    equal token prefixes give equal K/V bits (causality), so the digest
    of tokens [0, n) keys a reusable page; the length rides in the key."""
    return (n, hashlib.blake2b(prompt[:n].tobytes(),
                               digest_size=16).digest())


# --------------------------------------------------------------- requests
class Request:
    """One generation request riding through the engine."""

    __slots__ = ("id", "prompt", "max_new_tokens", "temperature", "top_k",
                 "eos_id", "tokens", "done", "finish_reason", "slot",
                 "_engine", "_pf_next", "_pfx_keys", "shared_tokens")

    def __init__(self, req_id, prompt, max_new_tokens, temperature, top_k,
                 eos_id):
        self.id = req_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.tokens: List[int] = []
        self.done = False
        self.finish_reason: Optional[str] = None
        self.slot: Optional[int] = None
        self._engine = None
        self._pf_next = None            # next chunked-prefill position
        self._pfx_keys = None           # memoized per-page prefix hashes
        self.shared_tokens = 0          # prompt tokens served from
        #                                 shared pages (prefix reuse)

    def cancel(self) -> bool:
        """Terminate this request now (finish_reason "cancelled")."""
        eng = self._engine
        return False if eng is None else eng.cancel(self)

    def __repr__(self):
        return (f"Request(id={self.id}, len={len(self.prompt)}, "
                f"gen={len(self.tokens)}/{self.max_new_tokens}, "
                f"done={self.done})")


# -------------------------------------------------------- device sampling
_M32 = 0xFFFFFFFF


def _mix32(h):
    """A 32-bit integer finalizer on int64 tensors holding values in
    [0, 2^32). Both multipliers are odd and below 2^31, so every product
    stays below 2^63 and int64 arithmetic is exact."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x46C8A68B) & _M32
    return h ^ (h >> 16)


def _gumbel(seed: int, req_ids, gen_idx, vocab: int):
    """Gumbel noise [N, V] that depends only on (seed, request id, token
    index, vocab index) — the port's counterpart of `_slot_keys`'
    fold_in(fold_in(key, request id), token index)."""
    dev = req_ids.device
    row = _mix32(torch.full(req_ids.shape, int(seed) & _M32,
                            dtype=torch.int64, device=dev))
    row = _mix32((row + req_ids.long() + 0x9E3779B9) & _M32)
    row = _mix32((row + gen_idx.long() + 0x9E3779B9) & _M32)
    v = torch.arange(vocab, device=dev, dtype=torch.int64)
    h = _mix32((row[:, None] ^ ((v * 0x2C1B3C6D) & _M32)) & _M32)
    h = _mix32((h + row[:, None]) & _M32)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))       # (0, 1)
    return -torch.log(-torch.log(u))


def _sample(lg, temps, top_ks, seed, req_ids, gen_idx, max_top_k: int):
    """lg [N,V] f32 -> next token [N] int32. Greedy where temp <= 0;
    otherwise a temperature draw, truncated to the request's top_k
    (<= the engine's max_top_k) when top_k > 0."""
    greedy = torch.argmax(lg, dim=-1)
    safe_t = temps.clamp_min(1e-6)[:, None]
    g = _gumbel(seed, req_ids, gen_idx, lg.shape[-1])
    sampled = torch.argmax(lg / safe_t + g, dim=-1)
    if max_top_k > 0:
        vals, idx = torch.topk(lg, max_top_k, dim=-1)              # [N,K]
        k_eff = torch.where(top_ks <= 0, max_top_k, top_ks).clamp_max(
            max_top_k)
        keep = torch.arange(max_top_k, device=lg.device)[None, :] \
            < k_eff[:, None]
        masked = vals.masked_fill(~keep, float("-inf"))
        choice = torch.argmax(masked / safe_t + g.gather(1, idx), dim=-1)
        trunc = idx.gather(1, choice[:, None])[:, 0]
        sampled = torch.where(top_ks > 0, trunc, sampled)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


# ---------------------------------------------------------- device bodies
# slot-state tuple riding through the decode tick (all [N] on the device)
#   (cur_tok, positions, active, temps, top_ks, req_ids, gen_idx)
@torch.no_grad()
def _decode_tick(params, cache, state, seed, *, fwd, cfg, max_top_k,
                 sampling, guard, oor_pos=None):
    """All N slots advance one token; inactive slots compute too (fixed
    shape) but their output is masked. A dense inactive row writes its
    K/V at its stale position, which the next prefill of that slot
    overwrites; under the paged layout the pool is shared, so an
    inactive row (one mid-chunked-prefill maps real, possibly shared,
    pages) writes at `oor_pos` = max_pages * page_size instead: past the
    table, onto the scratch page."""
    toks, positions, active, temps, top_ks, req_ids, gen_idx = state
    fpos = positions if oor_pos is None else torch.where(
        active, positions, torch.full_like(positions, oor_pos))
    logits, cache = fwd(params, toks[:, None], cache, fpos, cfg)
    lg = logits[:, 0].float()
    if sampling:
        nxt = _sample(lg, temps, top_ks, seed, req_ids, gen_idx, max_top_k)
    else:
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
    zero = torch.zeros_like(nxt)
    nxt = torch.where(active, nxt, zero)
    if guard:
        bad = active & ~torch.isfinite(lg).all(dim=-1)
        nxt = torch.where(bad, zero - 1, nxt)
    inc = active.to(torch.int32)
    return nxt, (nxt, positions + inc, active, temps, top_ks, req_ids,
                 gen_idx + inc)


@torch.no_grad()
def _prefill_slot(params, cache, padded, true_len: int, slot: int, temps,
                  top_ks, req_ids, seed, *, fwd, init_cache, cfg, max_top_k,
                  sampling, guard):
    """Bucketed prefill of ONE request into slot `slot`: the padded
    prompt runs through a fresh one-row cache of bucket length, the first
    token comes from the last real position, and the row is copied into
    the pool (wiping the slot's previous occupant up to the bucket)."""
    tb = padded.shape[1]
    mini = init_cache(cfg, 1, tb, device=padded.device)
    logits, mini = fwd(params, padded, mini, 0, cfg)
    last = logits[:, true_len - 1].float()                          # [1,V]
    if sampling:
        first = _sample(last, temps, top_ks, seed, req_ids,
                        torch.zeros_like(req_ids), max_top_k)[0]
    else:
        first = torch.argmax(last, dim=-1).to(torch.int32)[0]
    if guard:
        first = torch.where(torch.isfinite(last).all(), first,
                            torch.full_like(first, -1))
    cache["k"][:, slot, :tb] = mini["k"][:, 0]
    cache["v"][:, slot, :tb] = mini["v"][:, 0]
    return first


@torch.no_grad()
def _prefill_chunk(params, cache, padded, true_len: int, start: int,
                   slot: int, temps, top_ks, req_ids, seed, *, fwd, cfg,
                   max_top_k, sampling, guard):
    """Paged prefill of ONE chunk into slot `slot`: the padded chunk
    [1, cb] runs at absolute positions start.. against the slot's
    one-row paged view (its table row), scattering its K/V into the
    pool in place, and a token is drawn from the chunk's last real
    position, the first generated token when this is the prompt's last
    chunk (the host ignores it otherwise)."""
    sub = {"k": cache["k"], "v": cache["v"],
           "pt": cache["pt"][slot:slot + 1]}
    posv = torch.full((1,), start, dtype=torch.int64, device=padded.device)
    logits, _ = fwd(params, padded, sub, posv, cfg)
    last = logits[:, true_len - 1].float()                          # [1,V]
    if sampling:
        first = _sample(last, temps, top_ks, seed, req_ids,
                        torch.zeros_like(req_ids), max_top_k)[0]
    else:
        first = torch.argmax(last, dim=-1).to(torch.int32)[0]
    if guard:
        first = torch.where(torch.isfinite(last).all(), first,
                            torch.full_like(first, -1))
    return first


def _cow_copy(cache, src: int, dst: int) -> None:
    """Copy page `src` onto page `dst` in every layer of the pool, k and
    v: the copy-on-write materialization, in place."""
    for key in ("k", "v"):
        cache[key][:, dst] = cache[key][:, src]


def _to_device(params: dict, device) -> dict:
    from ..models.convert import params_from_jax
    out = {}
    host = {}
    for name, v in params.items():
        if isinstance(v, torch.Tensor):
            out[name] = v.to(device)
        else:
            host[name] = v
    if host:
        out.update(params_from_jax(host, device))
    return out


# ----------------------------------------------------------- the engine
class ServingEngine:
    """Iteration-level scheduler over a fixed slot pool.

    >>> eng = ServingEngine(params, cfg, family="gpt", num_slots=8)
    >>> req = eng.submit(prompt_ids, max_new_tokens=32)
    >>> while eng.has_work():
    ...     for r, tok in eng.step():   # (request, token) emissions
    ...         ...

    `generate(prompts, ...)` wraps submit + drain for batch use. The
    engine runs on the card unless `device="cpu"` is passed.

    Cache layout: `kv_layout` "dense" or "paged" ("auto": "paged" where
    `decode_attn_impl` says so, else dense); `page_size` tokens a page;
    `num_pages` in the pool (0: the dense-equivalent num_slots *
    max_pages + 1, the +1 for scratch); `prefill_chunk` tokens a prefill
    chunk (0: the whole suffix at once); `prefix_sharing` on or off.
    Speculative decode: `spec_decode` ("auto"|"off"|"spec"), `gamma`
    drafts a tick, `draft_layers` draft depth (0: half the layers).
    `multi_tick` ticks a dispatch (0: env > registry > 1). The host KV
    tier: `host_kv_bytes` of host RAM behind the page pool (0: off;
    paged layout with prefix sharing only).
    """

    def __init__(self, params, cfg, family="gpt", num_slots: int = 8,
                 max_len: Optional[int] = None, max_top_k: int = 0,
                 seed: int = 0, bucket_lo: int = 8, guardrails: bool = True,
                 quant: str = "auto", device=None, kv_layout: str = "auto",
                 page_size: int = 16, num_pages: int = 0,
                 prefill_chunk: int = 0, prefix_sharing: bool = True,
                 spec_decode: str = "auto", gamma: int = 4,
                 draft_layers: int = 0, multi_tick: int = 0,
                 host_kv_bytes: int = 0, **later_knobs):
        _check_unported(later_knobs)
        self.device = resolve_device(device)
        self.family = (family_for(family) if isinstance(family, str)
                       else family)
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.max_len = int(max_len or cfg.max_seq_len)
        if self.max_len > cfg.max_seq_len:
            raise ValueError(
                f"max_len ({self.max_len}) exceeds the model's "
                f"max_seq_len ({cfg.max_seq_len}): positions past it "
                "would clamp to GPT's position table or leave Llama's "
                "trained RoPE range, not error")
        self.max_top_k = int(max_top_k)
        self.seed = int(seed)
        self.bucket_lo = int(bucket_lo)
        self.guardrails = bool(guardrails)
        # speculative decode: the env's off values kill-switch even an
        # explicit "spec" (inference/spec_decode.resolve_spec)
        from .spec_decode import resolve_spec
        self.spec = resolve_spec(spec_decode, self.device)
        n_layers = int(cfg.num_layers)
        self.spec_gamma = int(gamma)
        self.spec_draft_layers = int(draft_layers) or max(1, n_layers // 2)
        if self.spec:
            if self.spec_gamma < 1:
                raise ValueError(f"gamma must be >= 1; got {gamma}")
            if not 1 <= self.spec_draft_layers <= n_layers:
                raise ValueError(
                    f"draft_layers ({self.spec_draft_layers}) must be in "
                    f"1..num_layers ({n_layers})")
        # ticks a dispatch; the env's off values kill-switch even an
        # explicit K (inference/multi_tick.resolve_multi_tick)
        from .multi_tick import resolve_multi_tick
        self.mt_k = resolve_multi_tick(multi_tick, self.device)
        # positions one dispatch writes per slot
        self._tick_span = self.mt_k * (self.spec_gamma + 1 if self.spec
                                       else 1)
        # cache layout
        if kv_layout == "auto":
            from ..kernels.decode_attention import decode_attn_impl
            kv_layout = ("paged" if decode_attn_impl(self.device) == "paged"
                         else "dense")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout {kv_layout!r} (auto|dense|paged)")
        self.paged = kv_layout == "paged"
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk)
        self.prefix_sharing = bool(prefix_sharing)
        # weight-only int8: a leaf rewrite at build, before the upload,
        # so the dropped fp matmul weights never reach the card
        from ..kernels.quant_matmul import resolve_quant
        self.quant = resolve_quant(quant, self.device)
        self._quant_info = None
        if self.quant:
            from ..quantization.serving import quantize_serving_params
            params, self._quant_info = quantize_serving_params(
                params, self.family.name)
            # the global kill switch turns the int8 sites into the plain
            # version on the card (on the CPU they run it anyway); read
            # here, so a captured graph keeps the route it was built with
            from ..kernels.quant_matmul import matmul_impl, quant_matmul_ref
            if self.device.type == "cuda" and \
                    matmul_impl(self.device) == "xla":
                self.family = dataclasses.replace(
                    self.family, forward_cached=functools.partial(
                        self.family.forward_cached, qmm=quant_matmul_ref))
        self._params = _to_device(params, self.device)
        n = self.num_slots
        if self.paged:
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1; "
                                 f"got {self.page_size}")
            self.max_pages = -(-self.max_len // self.page_size)     # ceil
            self.num_pages = int(num_pages) or n * self.max_pages + 1
            self._pool = _PagePool(self.num_pages, self.page_size)
            self._ptab = np.zeros((n, self.max_pages), np.int64)
            self._slot_reserve = np.zeros(n, np.int64)
            self._prefilling: collections.deque = collections.deque()
            self._pt_dirty = False
            self._cache = self._init_paged_cache()
        # the host tier behind the pool's eviction (paged layout with
        # prefix sharing: only registered pages spill)
        from .host_kv import HostKVTier, resolve_host_kv
        self.host_kv_bytes = resolve_host_kv(host_kv_bytes)
        self._host_tier = None
        self._host_stage: dict = {}   # prefix key -> uploaded (k, v)
        if self.paged and self.prefix_sharing and self.host_kv_bytes > 0:
            self._host_tier = HostKVTier(self.host_kv_bytes,
                                         pin=self.device.type == "cuda")
            self._pool.on_evict = self._spill_page
        if not self.paged:
            self._cache = self.family.init_cache(cfg, n, self.max_len,
                                                 device=self.device)
        # host mirrors of the slot state; the device copy is rebuilt
        # from them only when admission or a finish dirties them
        self._positions = np.zeros(n, np.int32)
        self._active = np.zeros(n, bool)
        self._cur_tok = np.zeros(n, np.int32)
        self._temps = np.zeros(n, np.float32)
        self._top_ks = np.zeros(n, np.int32)
        self._req_ids = np.zeros(n, np.int32)
        self._gen_idx = np.zeros(n, np.int32)
        # the multi-tick early-exit inputs: EOS id (-1: none), token budget
        self._eos_ids = np.full(n, -1, np.int32)
        self._max_new = np.zeros(n, np.int32)
        self._dstate = None
        self._dirty = True
        if self.mt_k > 1:
            # the static buffers a dispatch reads and advances in place
            # (a CUDA graph holds their addresses): the state tuple, then
            # eos_ids and max_new
            self._gbufs = tuple(
                torch.zeros(n, dtype=dt, device=self.device)
                for dt in (torch.int32, torch.int32, torch.bool,
                           torch.float32, torch.int32, torch.int32,
                           torch.int32, torch.int32, torch.int32))
            # on the card a dispatch is a CUDA graph replay
            self._graphed = self.device.type == "cuda"
            self._graphs: dict = {}          # sampling flag -> CUDAGraph
            self._graph_out: dict = {}       # sampling flag -> emit
            # sampling flag -> the family's held tensors the graph read
            self._graph_held: dict = {}
        self._slot_req: List[Optional[Request]] = [None] * n
        self._queue: collections.deque = collections.deque()
        self._next_id = 0
        self._ticks = 0
        # host-clock samples (ms) of each decode tick and each prefill
        # (each prefill chunk under the paged layout); a tick and a
        # final chunk end in the host pull that waits for the device, an
        # earlier chunk makes no pull
        self.tick_ms: collections.deque = collections.deque(maxlen=8192)
        self.prefill_ms: collections.deque = collections.deque(maxlen=8192)
        # host ms of each CUDA graph capture
        self.capture_ms: List[float] = []
        # decode_ticks: dispatches (K ticks each under multi-tick);
        # prefix_hits: pages mapped from the prefix map or swapped in
        # from the host tier at admission; spec_proposed/accepted:
        # drafts of greedy slots; graph_captures/replays: CUDA graphs of
        # the K-tick dispatch captured and replayed
        self.counters = {"prefills": 0, "decode_ticks": 0,
                         "tokens_emitted": 0, "quant_matmuls": 0,
                         "prefill_chunks": 0, "cow_copies": 0,
                         "prefix_hits": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "graph_captures": 0,
                         "graph_replays": 0}
        # fused dequant-matmuls per full forward: quantized leaves per
        # layer x depth + the head (the reference's formula); a spec
        # tick adds gamma draft passes of draft_layers layers + the head
        self._qmm_full = self._qmm_draft = 0
        if self._quant_info:
            per, head = self._quant_info["per_layer"], \
                self._quant_info["head"]
            self._qmm_full = per * n_layers + head
            self._qmm_draft = per * self.spec_draft_layers + head

    def _init_paged_cache(self) -> dict:
        """The page pool {"k","v": [L, P, page_size, heads, hd]} in the
        family's cache dtype, and the device page table "pt"."""
        probe = self.family.init_cache(self.cfg, 1, 1, device=self.device)
        shp = probe["k"].shape                       # [L, 1, 1, heads, hd]
        pages = (shp[0], self.num_pages, self.page_size) + tuple(shp[3:])
        return {"k": torch.zeros(pages, dtype=probe["k"].dtype,
                                 device=self.device),
                "v": torch.zeros(pages, dtype=probe["v"].dtype,
                                 device=self.device),
                "pt": self._upload(self._ptab)}

    # ------------------------------------------------------- observables
    def quant_stats(self) -> dict:
        if not self._quant_info:
            return {"quant": "off"}
        return {"quant": "int8", **self._quant_info}

    def pool_stats(self) -> dict:
        """The page pool in plain numbers (paged layout): page states,
        the COW copies, prefill chunks and prefix-hit pages so far, and
        the host tier's entries, bytes, spills, swap-ins and drops."""
        if not self.paged:
            return {"layout": "dense"}
        st = {"layout": "paged", **self._pool.stats(),
              **{k: self.counters[k] for k in
                 ("cow_copies", "prefill_chunks", "prefix_hits")}}
        if self._host_tier is not None:
            st["host_tier"] = self._host_tier.stats()
        return st

    def memory_ledger(self) -> dict:
        """cost_model.serving_memory_ledger of this engine's live
        configuration: device bytes by component, the host tier as
        `kv_pool_host` outside the device total."""
        from ..cost_model import serving_memory_ledger
        return serving_memory_ledger(
            self.cfg, family=self.family.name,
            layout="paged" if self.paged else "dense",
            quant="int8" if self._quant_info else "off",
            num_slots=self.num_slots, max_len=self.max_len,
            page_size=self.page_size,
            num_pages=self.num_pages if self.paged else 0,
            cache_bytes_per_elem=self._cache["k"].element_size(),
            dtype_bytes=self.cfg.dtype.itemsize,
            host_kv_bytes=(self._host_tier.bytes
                           if self._host_tier is not None else 0))

    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._active.any())
                or any(r is not None for r in self._slot_req))

    # --------------------------------------------------------- admission
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, eos_id: Optional[int] = None) -> Request:
        """Queue one request (prompt: 1-D int token ids). Returns the
        live Request; its .tokens fill in as the engine steps."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        t0 = prompt.shape[0]
        if t0 < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1; "
                             f"got {max_new_tokens}")
        if t0 + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine's max_len ({self.max_len})")
        if top_k > 0 and self.max_top_k <= 0:
            raise ValueError(
                "engine was built with max_top_k=0 (greedy/temperature "
                "only); rebuild with max_top_k >= the largest top_k")
        if top_k > self.max_top_k:
            raise ValueError(f"top_k={top_k} exceeds the engine's "
                             f"max_top_k={self.max_top_k}")
        if self.paged:
            need = self._pages_needed(t0, max_new_tokens)
            if need > self.num_pages - 1:
                raise PoolExhaustedError(
                    f"request needs {need} pages worst-case but the "
                    f"pool holds {self.num_pages - 1} allocatable pages "
                    f"(page_size={self.page_size})",
                    pages_needed=need, pages_total=self.num_pages - 1)
        req = Request(self._next_id, prompt, int(max_new_tokens),
                      float(temperature), int(top_k), eos_id)
        req._engine = self
        self._next_id += 1
        self._queue.append(req)
        return req

    # --------------------------------------------------------- the tick
    def step(self):
        """One engine tick: advance ONE mid-prefill slot by one chunk
        (paged), admit queued requests into free slots (one bucketed
        prefill each; under the paged layout only when the request's
        page reservation fits, else it waits at the head of the queue),
        then advance every active slot through the decode tick. Returns
        this tick's (request, token) emissions."""
        events: List[tuple] = []
        if self.paged:
            self._advance_prefill(events)
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                break
            head = self._queue[0]
            if self.paged and (self._plan_admission(head)[4]
                               > self._pool.available()):
                # FCFS: the head waits for pages to free; its host-tier
                # pages upload meanwhile
                self._prefetch_host(head)
                break
            self._queue.popleft()
            try:
                self._admit(slot, head, events)
            except BaseException:
                # no limbo: the request resolves before the error surfaces
                self._rollback_slot(slot, head)
                self._finish(head, "evicted")
                raise
        if self._active.any():
            self._decode(events)
        self._ticks += 1
        return events

    def drain(self, max_ticks: Optional[int] = None):
        """Step until idle (or max_ticks); returns all emissions."""
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
                 max_ticks: Optional[int] = None) -> List[np.ndarray]:
        """Submit every prompt, drain, and return each request's
        generated ids in submission order. What `max_ticks` left
        undelivered resolves as "evicted" before returning."""
        reqs = [self.submit(p, max_new_tokens, temperature=temperature,
                            top_k=top_k, eos_id=eos_id) for p in prompts]
        self.drain(max_ticks)
        for r in reqs:
            if not r.done:
                if r.slot is None:
                    try:
                        self._queue.remove(r)
                    except ValueError:
                        pass
                self._finish(r, "evicted")
        return [np.asarray(r.tokens, np.int32) for r in reqs]

    # ------------------------------------------------------ terminality
    def _clear_slot(self, slot: int) -> None:
        """Return a slot to the free pool: registry and every host
        mirror; the device state is rebuilt before the next tick. Under
        the paged layout the slot's pages release here too (registered
        ones park in the LRU cache), the table row snaps back to
        scratch, and the unspent reservation returns to the pool."""
        self._slot_req[slot] = None
        self._active[slot] = False
        self._positions[slot] = 0
        self._cur_tok[slot] = 0
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._gen_idx[slot] = 0
        self._eos_ids[slot] = -1
        self._max_new[slot] = 0
        self._dirty = True
        if self.paged:
            row = self._ptab[slot]
            for j in np.nonzero(row)[0]:
                self._pool.release(int(row[j]))
            row[:] = 0
            self._pool.reserved -= int(self._slot_reserve[slot])
            self._slot_reserve[slot] = 0
            self._pt_dirty = True
            try:
                self._prefilling.remove(slot)
            except ValueError:
                pass

    def _rollback_slot(self, slot: int, req: Request) -> None:
        if self._slot_req[slot] is req:
            self._clear_slot(slot)
        req.slot = None

    def _finish(self, req: Request, reason: str) -> None:
        """THE terminal transition, exactly once per request."""
        if req.done:
            return
        if req.slot is not None:
            self._clear_slot(req.slot)
        req.slot = None
        req.done = True
        req.finish_reason = reason

    def cancel(self, req: Request) -> bool:
        """Resolve `req` as "cancelled" now. False when already done."""
        if req.done:
            return False
        if req.slot is None:
            try:
                self._queue.remove(req)
            except ValueError:
                pass
            if self._host_stage:          # its prefetched host pages
                for key in self._prefix_keys(req):
                    self._host_stage.pop(key, None)
        self._finish(req, "cancelled")
        return True

    def _maybe_finish(self, req: Request) -> None:
        slot = req.slot
        if req.eos_id is not None and req.tokens[-1] == req.eos_id:
            self._finish(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length")
        elif slot is not None and self._positions[slot] >= self.max_len:
            self._finish(req, "evicted")   # cache full; submit's length
            #                                check makes it unreachable

    def _poisoned(self, req: Request, where: str) -> None:
        print(f"[serving] non-finite {where} logits (request {req.id}); "
              "quarantined", file=sys.stderr, flush=True)
        self._finish(req, "poisoned")

    # ---------------------------------------------------------- plumbing
    def _free_slot(self) -> Optional[int]:
        for i in range(self.num_slots):
            if self._slot_req[i] is None:
                return i
        return None

    def _upload(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _admit(self, slot: int, req: Request, events: list) -> None:
        if self.paged:
            return self._admit_paged(slot, req, events)
        t0 = len(req.prompt)
        tb = prompt_bucket(t0, self.max_len, self.bucket_lo)
        padded = np.zeros((1, tb), np.int64)
        padded[0, :t0] = req.prompt
        t_pf0 = time.perf_counter()
        first = _prefill_slot(
            self._params, self._cache, self._upload(padded), t0, slot,
            self._upload([req.temperature], torch.float32),
            self._upload([req.top_k], torch.int32),
            self._upload([req.id], torch.int32), self.seed,
            fwd=self.family.forward_cached,
            init_cache=self.family.init_cache, cfg=self.cfg,
            max_top_k=self.max_top_k, sampling=req.temperature > 0.0,
            guard=self.guardrails)
        tok = int(first.item())          # the admission's one host pull
        self.prefill_ms.append((time.perf_counter() - t_pf0) * 1e3)
        self.counters["prefills"] += 1
        self.counters["quant_matmuls"] += self._qmm_full
        if tok < 0:
            # never activated: the slot's cache row is masked garbage
            # until the next occupant's prefill overwrites it
            self._poisoned(req, "prefill")
            return
        self._activate_slot(slot, req, tok, events)

    def _activate_slot(self, slot: int, req: Request, tok: int,
                       events: list) -> None:
        """Prefill done: emit the first token, arm the host mirrors and
        hand the slot to the decode tick."""
        req.slot = slot
        self._slot_req[slot] = req
        self._positions[slot] = len(req.prompt)
        self._active[slot] = True
        self._cur_tok[slot] = tok
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._req_ids[slot] = req.id
        self._gen_idx[slot] = 1
        self._eos_ids[slot] = -1 if req.eos_id is None else int(req.eos_id)
        self._max_new[slot] = req.max_new_tokens
        self._dirty = True
        req.tokens.append(tok)
        events.append((req, tok))
        self.counters["tokens_emitted"] += 1
        self._maybe_finish(req)

    def _decode(self, events: list) -> None:
        if self.paged:
            # every active slot's write pages for the whole dispatch must
            # exist and be private before it scatters into them
            self._prepare_tick_pages()
            self._sync_page_table()
        sampling = bool(np.any(self._temps[self._active] > 0.0))
        t_dev0 = time.perf_counter()
        emit = self._dispatch(sampling)
        # ONE host pull per dispatch: the [N, K] emission matrix, K
        # blocks of gamma+1 columns under spec decode
        toks = emit.cpu().numpy().reshape(self.num_slots, -1)
        self.tick_ms.append((time.perf_counter() - t_dev0) * 1e3)
        self.counters["decode_ticks"] += 1
        self.counters["quant_matmuls"] += self.mt_k * (
            self._qmm_full
            + (self.spec_gamma * self._qmm_draft if self.spec else 0))
        if self.spec:
            self._apply_spec_emissions(toks, events)
        else:
            self._apply_multi_emissions(toks, events)

    def _tick_kw(self, sampling: bool) -> dict:
        kw = dict(fwd=self.family.forward_cached, cfg=self.cfg,
                  max_top_k=self.max_top_k, sampling=sampling,
                  guard=self.guardrails,
                  oor_pos=(self.max_pages * self.page_size if self.paged
                           else None))
        if self.spec:
            kw.update(gamma=self.spec_gamma,
                      draft_layers=self.spec_draft_layers)
        return kw

    def _dispatch(self, sampling: bool):
        """Run one dispatch on the device; returns the emission tensor.
        K = 1: the eager tick over `_dstate`, re-uploaded from the host
        mirrors when dirty. K >= 2: the K-tick function over the static
        buffers, eagerly on the CPU; on the card the first dispatch of
        each `sampling` flag runs it eagerly on a side stream and then
        captures it in a CUDA graph, and every later one replays that
        graph."""
        if self.mt_k == 1:
            if self._dirty:
                self._dstate = (
                    self._upload(self._cur_tok),
                    self._upload(self._positions),
                    self._upload(self._active), self._upload(self._temps),
                    self._upload(self._top_ks), self._upload(self._req_ids),
                    self._upload(self._gen_idx))
                self._dirty = False
            if self.spec:
                from .spec_decode import spec_tick
                nxt, self._dstate = spec_tick(
                    self._params, self._cache, self._dstate, self.seed,
                    **self._tick_kw(sampling))
            else:
                nxt, self._dstate = _decode_tick(
                    self._params, self._cache, self._dstate, self.seed,
                    **self._tick_kw(sampling))
            return nxt
        if self._dirty:
            for buf, host in zip(self._gbufs, (
                    self._cur_tok, self._positions, self._active,
                    self._temps, self._top_ks, self._req_ids, self._gen_idx,
                    self._eos_ids, self._max_new)):
                buf.copy_(torch.from_numpy(host))
            self._dirty = False
        if not self._graphed:
            return self._multi_ticks(sampling)
        graph = self._graphs.get(sampling)
        if graph is not None:
            graph.replay()
            self.counters["graph_replays"] += 1
            return self._graph_out[sampling]
        side = _CAPTURE_STREAMS.get(self.device.index)
        if side is None:
            side = _CAPTURE_STREAMS[self.device.index] = torch.cuda.Stream(
                self.device)
        main = torch.cuda.current_stream(self.device)
        # the warm-up: a real dispatch, eagerly on the capture's stream,
        # which also sizes every workspace the graph will bake
        side.wait_stream(main)
        with torch.cuda.stream(side):
            emit = self._multi_ticks(sampling)
        main.wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = self._multi_ticks(sampling)    # recorded, not run
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        self._graphs[sampling] = graph
        self._graph_out[sampling] = out
        # the memoized tensors the capture just read (the RoPE tables):
        # held here, so no eviction can free an address the graph baked
        self._graph_held[sampling] = self.family.held_tensors(self.cfg,
                                                              self._cache)
        self.counters["graph_captures"] += 1
        return emit

    def _multi_ticks(self, sampling: bool):
        """The K-tick function over the static buffers: the ticks, then
        the advanced state copied back into the buffers in place (the
        body a CUDA graph captures). Returns the emission matrix."""
        from .multi_tick import multi_tick_spec_ticks, multi_tick_ticks
        fn = multi_tick_spec_ticks if self.spec else multi_tick_ticks
        state, (eos_ids, max_new) = self._gbufs[:7], self._gbufs[7:]
        emit, new = fn(self._params, self._cache, state, self.seed, eos_ids,
                       max_new, k_ticks=self.mt_k, max_len=self.max_len,
                       **self._tick_kw(sampling))
        for buf, val in zip(state, new):
            buf.copy_(val)
        return emit

    def _emit_token(self, i: int, req: Request, tok: int,
                    events: list) -> None:
        """Mirror exactly what the tick did on the device (position and
        token index advanced under the active mask), record the token,
        run the finish checks."""
        self._positions[i] += 1
        self._cur_tok[i] = tok
        self._gen_idx[i] += 1
        req.tokens.append(tok)
        events.append((req, tok))
        self.counters["tokens_emitted"] += 1
        self._maybe_finish(req)

    def _apply_multi_emissions(self, toks, events: list) -> None:
        """Non-spec bookkeeping over the [N, K] emission matrix: column j
        is the token tick j emitted, MT_PAD after the slot retired on the
        device, -1 the quarantine verdict. The columns replay through
        `_emit_token`, so the host's finish rules fire on the token the
        device retired on and a surviving slot's mirrors land where the
        device state did. A quarantined slot alone is finished; its
        finish dirties the device state, so co-batched rows rebuild from
        their clean mirrors."""
        from .multi_tick import MT_PAD
        for i in np.nonzero(self._active)[0]:
            req = self._slot_req[i]
            for tok in toks[i].tolist():
                if tok == MT_PAD:
                    break
                if tok < 0:
                    self._poisoned(req, "decode")
                    break
                self._emit_token(i, req, tok, events)
                if req.done:
                    break

    def _apply_spec_emissions(self, toks, events: list) -> None:
        """Spec bookkeeping over the emission matrix: K blocks of
        gamma+1 columns (one under the single tick). In a block, column 0
        is a real token or the -1 verdict and the accepted drafts follow;
        a block opening with SPEC_PAD means the slot retired in an
        earlier one. The device advanced each slot by its accepted count
        + 1 a block; the mirrors advance token by token through
        `_emit_token`, so a request that finishes inside a block drops
        the rest (the non-spec engine would never have made them) and
        its finish dirties the device state. A slot flagged in a later
        block is finished after the tokens it emitted before. Under the
        paged layout, pages past each surviving slot's new position held
        only rejected drafts and roll back to the pool."""
        from .spec_decode import SPEC_PAD
        width = self.spec_gamma + 1
        for i in np.nonzero(self._active)[0]:
            req = self._slot_req[i]
            flat = toks[i].tolist()
            emit, poisoned = [], False
            for b in range(0, len(flat), width):
                row = flat[b:b + width]
                if b and row[0] == SPEC_PAD:
                    break
                if row[0] < 0:
                    poisoned = True
                    break
                cut = row.index(SPEC_PAD) if SPEC_PAD in row else len(row)
                if self._temps[i] <= 0.0:    # sampled slots never propose
                    self.counters["spec_proposed"] += self.spec_gamma
                    self.counters["spec_accepted"] += cut - 1
                emit.extend(row[:cut])
            for tok in emit:
                self._emit_token(i, req, tok, events)
                if req.done:
                    break
            if poisoned and not req.done:
                self._poisoned(req, "decode")
        if self.paged:
            for i in np.nonzero(self._active)[0]:
                self._rollback_spec_pages(int(i))

    # ------------------------------------------------- paged scheduling
    def _sync_page_table(self) -> None:
        # in place: a captured graph holds the table's address
        if self._pt_dirty:
            self._cache["pt"].copy_(torch.from_numpy(self._ptab))
            self._pt_dirty = False

    def _pages_needed(self, t0: int, max_new: int) -> int:
        """Worst-case page envelope of one request: positions 0 .. t0 +
        max_new - 2 are written (the last sampled token never is)."""
        return -(-(t0 + max_new - 1) // self.page_size)

    def _plan_admission(self, req: Request):
        """(matched, aligned_full, suffix_start, need, gross). `matched`
        is the prompt's prefix as a chain of ("dev", page id) and
        ("host", prefix key) entries: the walk looks in the device's
        prefix map first, then in the host tier, and stops at the first
        miss. `need` is the worst-case pages the request will still
        allocate (a host hit costs one, its swap-in); `gross` also
        counts cached pages the match pulls back live (they stop being
        evictable for others). The suffix always re-runs at least one
        prompt token (its logits give the first token), so a fully
        page-aligned match copies its last page (aligned_full) and
        recomputes the last prompt token there."""
        t0 = len(req.prompt)
        ps = self.page_size
        matched: List[tuple] = []
        n_dev = 0
        if self.prefix_sharing:
            for key in self._prefix_keys(req):
                pid = self._pool.lookup(key)
                if pid is not None:
                    matched.append(("dev", pid))
                    n_dev += 1
                elif self._host_tier is not None and (
                        key in self._host_stage or key in self._host_tier):
                    matched.append(("host", key))
                else:
                    break
        aligned_full = (bool(matched) and len(matched) == t0 // ps
                        and t0 % ps == 0)
        suffix_start = (t0 - 1) if aligned_full else len(matched) * ps
        need = (self._pages_needed(t0, req.max_new_tokens) - n_dev
                + (1 if aligned_full else 0))
        gross = need + sum(1 for kind, pid in matched
                           if kind == "dev" and self._pool.ref[pid] == 0)
        if gross > self.num_pages - 1:
            # an aligned-full match costs one page over the envelope; in
            # a pool sized exactly to it the request would queue forever,
            # so admit it unshared (submit checked the envelope fits)
            matched, aligned_full, suffix_start = [], False, 0
            need = gross = self._pages_needed(t0, req.max_new_tokens)
        return matched, aligned_full, suffix_start, need, gross

    def _prefix_keys(self, req: Request):
        """The request's per-page prefix hashes, memoized on the Request:
        the head of the queue replans every tick while it waits."""
        if req._pfx_keys is None:
            ps = self.page_size
            req._pfx_keys = [_prefix_key(req.prompt, (j + 1) * ps)
                             for j in range(len(req.prompt) // ps)]
        return req._pfx_keys

    def _admit_paged(self, slot: int, req: Request, events: list) -> None:
        """Paged admission: map the shared prompt-prefix pages (refcounts
        up), swap the host tier's hits into fresh pages (re-registered,
        so later sharers hit the device), reserve the worst-case
        remainder, then prefill the unshared suffix, at once when it fits
        one chunk, else one chunk a tick through `_advance_prefill`.
        step() checked the reservation fits."""
        matched, aligned_full, suffix_start, need, _ = \
            self._plan_admission(req)
        # the host pages' data before any alloc(): an eviction spills into
        # the tier, whose own LRU could drop a key this admission needs
        staged = {}
        for kind, key in matched:
            if kind == "host":
                staged[key] = (self._host_stage.pop(key, None)
                               or self._upload_pair(self._host_tier.get(key)))
        if self._host_stage:
            for key in self._prefix_keys(req):
                self._host_stage.pop(key, None)     # uploads the plan skipped
        req.slot = slot
        self._slot_req[slot] = req
        self._pool.reserved += need
        self._slot_reserve[slot] = need
        # retain every device hit before a swap-in's alloc() could evict
        # one of them from the LRU cache
        for j, (kind, pid) in enumerate(matched):
            if kind == "dev":
                self._pool.retain(pid)
                self._ptab[slot, j] = pid
        for j, (kind, key) in enumerate(matched):
            if kind == "host":
                pid = self._alloc_slot_page(slot, j)
                for name, page in zip(("k", "v"), staged[key]):
                    # in place: a captured graph holds the pool's address
                    self._cache[name][:, pid].copy_(page)
                self._pool.register(pid, key)
                self._host_tier.swapins += 1
        if matched:
            self._pt_dirty = True
        self.counters["prefix_hits"] += len(matched)
        req.shared_tokens = suffix_start
        req._pf_next = suffix_start
        t0 = len(req.prompt)
        if aligned_full:
            # the suffix rewrites the last prompt token's K/V into the
            # last matched page: a private copy first
            self._ensure_private(slot, (t0 - 1) // self.page_size)
        if self.prefill_chunk <= 0 or t0 - suffix_start <= \
                self.prefill_chunk:
            self._run_chunk(slot, req, events)
        else:
            self._prefilling.append(slot)

    def _run_chunk(self, slot: int, req: Request, events: list) -> None:
        """One prefill chunk of `slot`: make the pages its real tokens
        land in private, run the chunk, and on the prompt's last chunk
        pull the first token, register the full prompt pages for later
        sharers and activate the slot. Earlier chunks make no pull."""
        t0 = len(req.prompt)
        ps = self.page_size
        start = req._pf_next
        end = (t0 if self.prefill_chunk <= 0
               else min(start + self.prefill_chunk, t0))
        clen = end - start
        for j in range(start // ps, (end - 1) // ps + 1):
            self._ensure_private(slot, j)
        cb = prompt_bucket(clen, self.max_len, self.bucket_lo)
        padded = np.zeros((1, cb), np.int64)
        padded[0, :clen] = req.prompt[start:end]
        self._sync_page_table()
        final = end == t0
        t_pf0 = time.perf_counter()
        first = _prefill_chunk(
            self._params, self._cache, self._upload(padded), clen, start,
            slot, self._upload([req.temperature], torch.float32),
            self._upload([req.top_k], torch.int32),
            self._upload([req.id], torch.int32), self.seed,
            fwd=self.family.forward_cached, cfg=self.cfg,
            max_top_k=self.max_top_k,
            sampling=final and req.temperature > 0.0, guard=self.guardrails)
        tok = int(first.item()) if final else None    # the one host pull
        self.prefill_ms.append((time.perf_counter() - t_pf0) * 1e3)
        self.counters["prefill_chunks"] += 1
        self.counters["quant_matmuls"] += self._qmm_full
        if not final:
            req._pf_next = end
            return
        req._pf_next = None
        self.counters["prefills"] += 1
        if tok < 0:
            # quarantined before registration: a poisoned prompt's pages
            # are never published
            self._poisoned(req, "prefill")
            return
        if self.prefix_sharing:
            for j, key in enumerate(self._prefix_keys(req)):
                self._pool.register(int(self._ptab[slot, j]), key)
        self._activate_slot(slot, req, tok, events)

    def _advance_prefill(self, events: list) -> None:
        """The chunked-prefill interleave: at most ONE chunk a tick (FCFS
        over the mid-prefill slots), so decoding streams wait at most one
        chunk a token however long a joining prompt is."""
        while self._prefilling:
            slot = self._prefilling[0]
            req = self._slot_req[slot]
            if req is None or req.done or req._pf_next is None:
                self._prefilling.popleft()       # evicted or cancelled
                continue
            try:
                self._run_chunk(slot, req, events)
            except BaseException:
                self._finish(req, "evicted")     # frees its pages
                raise
            if req.done or req._pf_next is None:
                if self._prefilling and self._prefilling[0] == slot:
                    self._prefilling.popleft()
            return

    # ---------------------------------------------------- host KV tier
    def _spill_page(self, pid: int, key) -> None:
        """The pool's on_evict tap: copy the evicting registered page to
        the host tier before its prefix entry drops. A registered page is
        immutable (COW), so the copy is bit-equal to what a device hit
        would read. A key the tier holds already (a page that went host,
        device and is evicted again) is not copied twice."""
        if key not in self._host_tier:
            self._host_tier.put(key, self._cache["k"][:, pid],
                                self._cache["v"][:, pid])

    def _upload_pair(self, pair):
        """A host page pair on its way to the device: asynchronous from
        pinned memory on the card."""
        return tuple(t.to(self.device, non_blocking=True) for t in pair)

    def _prefetch_host(self, req: Request) -> None:
        """While the head of the queue waits for pages, start uploading
        the host-tier pages its prefix walk will hit, so the transfers
        overlap the wait; `_admit_paged` consumes them. Idempotent per
        key. Only the head's uploads are kept: a head that left the
        queue unadmitted (cancelled) leaves none behind once another
        head waits."""
        if self._host_tier is None:
            return
        keys = self._prefix_keys(req)
        if self._host_stage:
            for key in set(self._host_stage).difference(keys):
                del self._host_stage[key]
        for key in keys:
            if key in self._host_stage or key in self._pool.by_key:
                continue
            pair = self._host_tier.get(key)
            if pair is None:
                break           # the walk stops at the first miss too
            self._host_stage[key] = self._upload_pair(pair)

    def _alloc_slot_page(self, slot: int, j: int) -> int:
        """A private page for table entry (slot, j), drawn on the slot's
        admission reservation while one remains."""
        pid = self._pool.alloc()
        if self._slot_reserve[slot] > 0:
            self._slot_reserve[slot] -= 1
            self._pool.reserved -= 1
        self._ptab[slot, j] = pid
        self._pt_dirty = True
        return pid

    def _ensure_private(self, slot: int, j: int) -> int:
        """THE copy-on-write seam: make table entry (slot, j) safe to
        write. Unmapped: allocate. Frozen (shared or registered): copy
        its contents into a fresh page, swap the entry, drop the old
        reference. Private: nothing to do."""
        pid = int(self._ptab[slot, j])
        if pid != 0 and not self._pool.is_frozen(pid):
            return pid
        new = self._alloc_slot_page(slot, j)
        if pid != 0:
            _cow_copy(self._cache, pid, new)
            self._pool.release(pid)
            self.counters["cow_copies"] += 1
        return new

    def _prepare_tick_pages(self) -> None:
        """Every page an active slot writes this tick (positions pos ..
        pos + span - 1; span gamma + 1 under spec decode) must exist and
        be private before the tick. The span is clamped to the request's
        write envelope (position t0 + max_new - 2 is the last ever
        written), so a draft past it lands on scratch through the
        unmapped table rather than drawing pages never reserved."""
        ps = self.page_size
        for i in np.nonzero(self._active)[0]:
            pos = int(self._positions[i])
            req = self._slot_req[int(i)]
            last = min(pos + self._tick_span - 1,
                       len(req.prompt) + req.max_new_tokens - 2)
            for j in range(pos // ps, min(last // ps + 1, self.max_pages)):
                self._ensure_private(int(i), j)

    def _rollback_spec_pages(self, slot: int) -> None:
        """After a spec tick, a page mapped past the slot's new position
        holds only rejected drafts: it goes back to the pool and the
        reservation is restored, so between ticks the pool accounts
        exactly as the non-spec engine's does. Such pages are private and
        unregistered (only prompt pages register), so release() frees
        them."""
        pos = int(self._positions[slot])
        ps = self.page_size
        row = self._ptab[slot]
        first = -(-pos // ps)        # page j holds a token iff j*ps < pos
        # only this tick's span can be mapped past `first`
        last = min((pos + self._tick_span - 2) // ps + 1, self.max_pages)
        for j in range(first, last):
            pid = int(row[j])
            if pid == 0:
                continue
            self._pool.release(pid)
            self._slot_reserve[slot] += 1
            self._pool.reserved += 1
            row[j] = 0
            self._pt_dirty = True


def create_serving_engine(model_or_params, cfg=None, **kw) -> ServingEngine:
    """Build a ServingEngine from a facade model (GPTModel, LlamaModel —
    family, params and device are taken from it) or from a (params, cfg)
    pair plus family=..."""
    from ..models.facade import FacadeModel
    if isinstance(model_or_params, FacadeModel):
        model = model_or_params
        kw.setdefault("family", model._serving_family)
        kw.setdefault("device", model.device)
        return ServingEngine(model.param_tree(), model.cfg, **kw)
    if cfg is None:
        raise ValueError("create_serving_engine(params, cfg, ...) needs "
                         "the model config")
    return ServingEngine(model_or_params, cfg, **kw)
