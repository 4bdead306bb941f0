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

Sampled streams are the reference's: each slot draws with the threefry
key fold_in(fold_in(PRNGKey(seed), request id), token index), through
the port's own copy of jax.random (inference/prng.py), so a request's
sampled stream depends only on those three values, never on its slot or
on the rest of the batch, and equals the JAX engine's wherever their
logits rank the candidates alike. The keys and the Gumbel noise are
tensor ops on the device, with no host sync.

- **Tensor-parallel serving** (mesh=, tp_axis=; the reference's
  SERVING_PARAM_SPECS and decode_attention.cache_pspecs under GSPMD).
  One engine a rank, every rank of the mesh's tp axis running the same
  host scheduler on the same requests. Each rank stores only its shard
  of every leaf (`_shard_params`: q/k/v/gate/up and GPT's qkv/mlp_up
  split by column, o/down by row, the embedding and the int8 head
  vocab-parallel, a column-parallel int8 scale with its weight, a
  row-parallel one whole; GPT's fused qkv stored head-grouped,
  models/gpt.py qkv_head_order) and of the KV cache (its KV heads;
  the page table whole); a leaf tp does not divide stays whole, as a
  Llama k/v with fewer KV heads than ranks does, its cache with it. The
  cached forwards run under a parallel/layout.py ServingLayout: two
  all-reduces a layer, one for the embedding, and the head's logits
  gathered whole before the sampler, so every rank draws the same
  tokens and pulls one array a tick. Every int8 matmul runs the kernel
  on the rank's own shard. tp composes with the paged pool, chunked
  prefill, COW, spec decode and multi-tick; a K >= 2 dispatch on the
  card is a CUDA graph, which can hold NCCL's collectives but not the
  host route two ranks sharing a card take
  ("gloo_cuda_via_all_reduce"): that combination raises at build.

Robustness (the reference's SLO guardrails). Every request resolves
exactly once with a finish reason from TERMINAL_REASONS, through the
one `_finish` seam:
- **Admission.** `max_queue` bounds the queue: "reject" raises
  BackpressureError at submit, "shed_oldest" evicts the oldest queued
  request; `queue_ttl_s` times a waiting request out.
- **Deadlines.** `deadline_s` / `deadline_ticks` bound a request's whole
  lifetime (queue wait included): checked over the queue, at the head of
  admission, and after each decode over every slot, mid-prefill ones
  included; an expired request ends "timeout". `abort_pending` resolves
  everything live.
- **Self-healing.** A raising prefill rolls its slot back and retries
  with backoff (`retries`, `backoff_base`, `backoff_max`); an exhausted
  budget evicts the request. A raising decode re-runs from the host
  mirrors: the device state (`_dstate`, or the K-tick static buffers)
  reloads from them, so the re-run writes the same K/V at the same
  positions. An exhausted budget, or a pull that outlives the watchdog
  (`watchdog_timeout` > 0: `_pull` through parallel/resilience's
  WatchdogPuller), hard-resets: in-flight requests end "evicted", the
  cache is reallocated, the CUDA graphs that baked the old cache are
  dropped and captured again, and queued requests admit into the fresh
  cache. The reference also resets when a failed dispatch consumed its
  donated cache (`_cache_dead`); a torch tensor is never consumed by a
  failed call, so here only the retry budget and the watchdog lead
  there. An allocation failure (`torch.OutOfMemoryError`, or an
  injected RESOURCE_EXHAUSTED) first dumps `oom_forensics` (the memory
  ledger, a census of the engine's tensors, pool and quant stats).
- **Fault seam.** `_FAULT_HOOK` (testing/faults.py installs it) is
  consulted once a tick for the serving fault kinds; `nan_logits` writes
  nan into one lane of the `[N]` poison multiplier the tick's logits
  are multiplied by (by 1.0 otherwise, which is exact), so injected and
  organic non-finite logits meet the same quarantine.

Observability. `serving.*` monitor counters, gauges and the
queue_wait_ms histogram; `RecordEvent` spans around every prefill and
decode dispatch; TTFT and inter-token samples (`slo_snapshot`,
`export_slo_jsonl`); in-tick telemetry (`telemetry=`, on by default,
profiler/serving_telemetry.py): the dispatch computes the TICK_FIELDS
row on the device and packs it beside its tokens, so the one pull
carries both (`tick_records()`, `telemetry_jsonl=`); request tracing
(`tracing=True`, profiler/tracing.py): queue, prefill chunk and decode
spans, a `decode.tick` instant a token, one terminal span.

The fleet seams (inference/router.py drives them): `snapshot_request`
pulls a mid-decode request's K/V and decode-state mirror to the host,
`restore_request` writes them into a free slot of another engine in
place with zero re-prefilled tokens, `detach_request` releases a
request that left without a terminal reason, `set_spec_drafts` toggles
speculative drafts live (the brownout's first lever), and
`rebuild_on_mesh` moves a tensor-parallel engine onto a smaller mesh
with its live streams (inference/autoscale.py EnginePreemptGuard).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.decode_attention import attended_tokens
from ..models.decode import prompt_bucket
from ..profiler import RecordEvent, monitor
from ..profiler.serving_telemetry import TICK_FIELDS, pack_tick_fields
from . import prng

__all__ = ["ServingEngine", "Request", "ModelFamily", "family_for",
           "create_serving_engine", "TERMINAL_REASONS",
           "BackpressureError", "PoolExhaustedError", "ServingFaultError"]

# every submitted request ends in exactly one of these
TERMINAL_REASONS = frozenset(
    {"eos", "length", "timeout", "cancelled", "poisoned", "evicted"})

# fault-injection seam (testing.faults.install wires it): called with the
# tick about to run, returns an action dict ({"poison_slot": i} |
# {"draft_poison_slot": i} | {"stall_s": s} | {"raise_prefill": True} |
# {"raise_decode": True} | {"raise_cow": True} | {"raise_oom": True} |
# {"raise_migrate": True}). Production code never sets it.
_FAULT_HOOK: Optional[Callable[[int], dict]] = None

# device index -> the side stream every engine's multi-tick warm-ups and
# CUDA graph captures run on: cuBLAS keeps a workspace for each stream it
# has run on, so a stream per engine would leave one behind per build
_CAPTURE_STREAMS: dict = {}
# one warm-up and capture at a time in the process (engines stepped on a
# router's threads share the side stream); a capture is thread-local, so
# other threads' launches and pulls go on meanwhile
_CAPTURE_LOCK = threading.Lock()


class BackpressureError(RuntimeError):
    """submit() refused: the admission queue is at max_queue (policy
    "reject"). Carries .queue_depth so a caller can report or shed."""

    def __init__(self, msg: str, queue_depth: int = 0):
        super().__init__(msg)
        self.queue_depth = queue_depth


class ServingFaultError(RuntimeError):
    """An injected serving fault (testing.faults prefill_raise,
    decode_raise, cow_raise, oom), raised at the device-call seam, so the
    retry path runs exactly what an organic dispatch failure would."""


def _is_oom(exc: BaseException) -> bool:
    """An allocation failure: torch's own, or one whose message carries
    the reference backend's marker (the injected `oom` fault)."""
    return (isinstance(exc, torch.OutOfMemoryError)
            or "RESOURCE_EXHAUSTED" in str(exc))


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
    # tensor-parallel serving: {leaf: spec over 'tp'} (the module's
    # SERVING_PARAM_SPECS), and the column order a leaf is stored in
    # before it is cut (name, full tensor, tp) -> tensor
    serving_specs: Optional[dict] = None
    serving_order: Callable = lambda name, value, tp: value


def _gpt_serving_order(name, value, tp):
    """GPT's fused qkv leaves in head-grouped column order
    (models/gpt.py qkv_head_order), so each rank's shard holds its
    heads' q, k and v."""
    if tp == 1 or name not in ("qkv_w", "qkv_w_q", "qkv_w_scale", "qkv_b"):
        return value
    from ..models.gpt import qkv_head_order
    idx = qkv_head_order(value.shape[-1] // 3, tp).to(value.device)
    return value.index_select(value.dim() - 1, idx)


def family_for(name: str) -> ModelFamily:
    if name == "gpt":
        from ..models import gpt
        return ModelFamily("gpt", gpt.gpt_forward_cached, gpt.init_kv_cache,
                           serving_specs=gpt.SERVING_PARAM_SPECS,
                           serving_order=_gpt_serving_order)
    if name == "llama":
        from ..models import llama
        return ModelFamily("llama", llama.llama_forward_cached,
                           llama.init_kv_cache, llama.cached_rope_tables,
                           serving_specs=llama.SERVING_PARAM_SPECS)
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
                 "deadline_s", "deadline_ticks", "t_submit", "_tick_submit",
                 "_t_last", "_engine", "_pf_next", "_pfx_keys",
                 "shared_tokens", "trace", "_sp_queue", "_sp_decode",
                 "tenant", "priority")

    def __init__(self, req_id, prompt, max_new_tokens, temperature, top_k,
                 eos_id, deadline_s=None, deadline_ticks=None,
                 tenant="default", priority=0):
        self.id = req_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        # multi-tenant labels: the engine carries them untouched (quotas
        # and preemption are the router's policy, inference/admission.py)
        self.tenant = tenant
        self.priority = int(priority)
        self.deadline_s = deadline_s           # wall seconds from submit
        self.deadline_ticks = deadline_ticks   # engine ticks from submit
        self.tokens: List[int] = []
        self.done = False
        self.finish_reason: Optional[str] = None
        self.slot: Optional[int] = None
        self.t_submit = 0.0
        self._tick_submit = 0
        self._t_last = 0.0              # last emission (SLO samples)
        self._engine = None
        self._pf_next = None            # next chunked-prefill position
        self._pfx_keys = None           # memoized per-page prefix hashes
        self.shared_tokens = 0          # prompt tokens served from
        #                                 shared pages (prefix reuse)
        self.trace = None               # RequestTrace (tracing=True)
        self._sp_queue = None           # open queue-span id
        self._sp_decode = None          # open decode-span id

    def cancel(self) -> bool:
        """Terminate this request now (finish_reason "cancelled")."""
        eng = self._engine
        return False if eng is None else eng.cancel(self)

    def __repr__(self):
        return (f"Request(id={self.id}, len={len(self.prompt)}, "
                f"gen={len(self.tokens)}/{self.max_new_tokens}, "
                f"done={self.done})")


# -------------------------------------------------------- device sampling
def _slot_keys(seed: int, req_ids, gen_idx):
    """Per-slot threefry keys fold_in(fold_in(PRNGKey(seed), request
    id), token index), the reference's `_slot_keys`: a stream depends on
    the request, never on its slot or the batch. Device tensors [N]
    each, computed with no host sync. `_sample` draws under the same
    keys, folded in by the draw itself (one kernel launch on the
    card)."""
    return prng.fold_in(prng.fold_in(prng.prng_key(seed), req_ids), gen_idx)


def _sample(lg, temps, top_ks, seed, req_ids, gen_idx, max_top_k: int):
    """lg [N,V] f32 -> next token [N] int32, the reference's `_sample`:
    greedy where temp <= 0; otherwise jax.random.categorical over the
    [V] logits / temp with the slot's key, or, where top_k > 0, over the
    [K] top-k values (<= the engine's max_top_k) with the same key, so
    that the noise at top-k rank j is the key's j-th draw."""
    greedy = torch.argmax(lg, dim=-1)
    safe_t = temps.clamp_min(1e-6)[:, None]
    # categorical(keys, lg / t) under the `_slot_keys` keys: the Gumbel
    # noise over [V], drawn once; the top-k draw's [K] noise under the
    # same key is its first K columns (a partitionable draw's element j
    # depends on the key and j alone)
    g = prng.gumbel(prng.prng_key(seed), (lg.shape[-1],),
                    fold=(req_ids, gen_idx))
    sampled = torch.argmax(g + lg / safe_t, dim=-1)
    if max_top_k > 0:
        vals, idx = torch.topk(lg, max_top_k, dim=-1)              # [N,K]
        k_eff = torch.where(top_ks <= 0, max_top_k, top_ks).clamp_max(
            max_top_k)
        keep = torch.arange(max_top_k, device=lg.device)[None, :] \
            < k_eff[:, None]
        masked = vals.masked_fill(~keep, float("-inf"))
        choice = torch.argmax(g[:, :max_top_k] + masked / safe_t, dim=-1)
        trunc = idx.gather(1, choice[:, None])[:, 0]
        sampled = torch.where(top_ks > 0, trunc, sampled)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


# ---------------------------------------------------------- device bodies
# slot-state tuple riding through the decode tick (all [N] on the device)
#   (cur_tok, positions, active, temps, top_ks, req_ids, gen_idx)
@torch.no_grad()
def _decode_tick(params, cache, state, seed, poison=None, *, fwd, cfg,
                 max_top_k, sampling, guard, oor_pos=None, tele=False):
    """All N slots advance one token; inactive slots compute too (fixed
    shape) but their output is masked. A dense inactive row writes its
    K/V at its stale position, which the next prefill of that slot
    overwrites; under the paged layout the pool is shared, so an
    inactive row (one mid-chunked-prefill maps real, possibly shared,
    pages) writes at `oor_pos` = max_pages * page_size instead: past the
    table, onto the scratch page. `poison` [N] f32 multiplies the logits
    under `guard` (ones, or nan in a lane the nan_logits fault poisons;
    multiplying by 1.0 is exact). With `tele` the TICK_FIELDS int32 row
    (profiler/serving_telemetry) is returned too: (nxt, row, state)."""
    toks, positions, active, temps, top_ks, req_ids, gen_idx = state
    fpos = positions if oor_pos is None else torch.where(
        active, positions, torch.full_like(positions, oor_pos))
    logits, cache = fwd(params, toks[:, None], cache, fpos, cfg)
    lg = logits[:, 0].float()
    if guard and poison is not None:
        lg = lg * poison[:, None]
    if sampling:
        nxt = _sample(lg, temps, top_ks, seed, req_ids, gen_idx, max_top_k)
    else:
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
    zero = torch.zeros_like(nxt)
    nxt = torch.where(active, nxt, zero)
    bad = torch.zeros_like(active)
    if guard:
        bad = active & ~torch.isfinite(lg).all(dim=-1)
        nxt = torch.where(bad, zero - 1, nxt)
    inc = active.to(torch.int32)
    state = (nxt, positions + inc, active, temps, top_ks, req_ids,
             gen_idx + inc)
    if not tele:
        return nxt, state
    return nxt, pack_tick_fields(
        tokens=(active & ~bad).sum(), active=active.sum(),
        poisoned=bad.sum(), attended=attended_tokens(positions, active)), \
        state


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


def _packed(outs) -> torch.Tensor:
    """A dispatch's outputs as the one int32 tensor the host pulls: the
    emission matrix, flattened, then (under telemetry) the TICK_FIELDS
    row."""
    if len(outs) == 1:
        return outs[0]
    return torch.cat([outs[0].reshape(-1), outs[1]])


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
    paged layout with prefix sharing only). Tensor parallelism: `mesh`
    (parallel.mesh.build_mesh({'tp': N}), or any mesh with a `tp_axis`
    axis; see parallel/planner.py plan_serving_tp for the degree), one
    engine a rank, built and driven alike on every rank; `params` are
    the FULL tree, which each rank cuts to its shards.

    Guardrails: `max_queue` (0: unbounded) with `queue_policy`
    ("reject"|"shed_oldest"), `queue_ttl_s` (0: none), the isfinite
    quarantine (`guardrails`), `watchdog_timeout` seconds on each pull
    (0: none), `retries` of a failed device call with `backoff_base`
    doubling up to `backoff_max` seconds. Observability: `telemetry`
    ("auto"|"on"|"off"; env PADDLE_TPU_SERVING_TELEMETRY kills it),
    `telemetry_jsonl` (a JSONL path) flushed every `telemetry_every`
    records, `tracing` (request span trees).
    """

    def __init__(self, params, cfg, family="gpt", num_slots: int = 8,
                 max_len: Optional[int] = None, max_top_k: int = 0,
                 seed: int = 0, bucket_lo: int = 8, guardrails: bool = True,
                 quant: str = "auto", device=None, kv_layout: str = "auto",
                 page_size: int = 16, num_pages: int = 0,
                 prefill_chunk: int = 0, prefix_sharing: bool = True,
                 spec_decode: str = "auto", gamma: int = 4,
                 draft_layers: int = 0, multi_tick: int = 0,
                 host_kv_bytes: int = 0, mesh=None, tp_axis: str = "tp",
                 max_queue: int = 0, queue_policy: str = "reject",
                 queue_ttl_s: float = 0.0, watchdog_timeout: float = 0.0,
                 retries: int = 2, backoff_base: float = 0.05,
                 backoff_max: float = 2.0, telemetry: str = "auto",
                 telemetry_jsonl: Optional[str] = None,
                 telemetry_every: int = 32, tracing: bool = False):
        if queue_policy not in ("reject", "shed_oldest"):
            raise ValueError(f"queue_policy {queue_policy!r} "
                             "(reject|shed_oldest)")
        self.max_queue = int(max_queue)              # 0: unbounded
        self.queue_policy = queue_policy
        self.queue_ttl_s = float(queue_ttl_s)        # 0: no TTL
        self.watchdog_timeout = float(watchdog_timeout)  # 0: no watchdog
        self.retries = int(retries)                  # device-call retries
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.family = (family_for(family) if isinstance(family, str)
                       else family)
        self.mesh = mesh
        self.tp_axis = str(tp_axis)
        self.tp = 1
        self._layout = None
        if mesh is not None:
            from ..parallel.mesh import axis_names, axis_size, mesh_device
            names = axis_names(mesh)
            if self.tp_axis not in names:
                raise ValueError(
                    f"mesh {dict(zip(names, tuple(mesh.shape)))} has no "
                    f"{self.tp_axis!r} axis (build it via parallel.mesh."
                    "build_mesh({'tp': N}) or pass tp_axis=)")
            if self.family.serving_specs is None:
                raise ValueError(
                    f"family {self.family.name!r} has no "
                    "SERVING_PARAM_SPECS — it cannot run tensor-parallel")
            self.tp = axis_size(mesh, self.tp_axis)
            if device is None:
                device = mesh_device(mesh)
        self.device = resolve_device(device)
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
        # only an engine built with spec on can turn its drafts back on
        # (set_spec_drafts)
        self._spec_capable = self.spec
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
        if self.tp > 1 and self.mt_k > 1:
            from ..parallel.collective import collective_route
            from ..parallel.mesh import axis_group
            route = collective_route(axis_group(mesh, self.tp_axis),
                                     self.device)
            if route == "gloo_cuda_via_all_reduce":
                raise NotImplementedError(
                    f"multi_tick={self.mt_k} under mesh=: a K >= 2 dispatch "
                    "on the card is a CUDA graph, which cannot capture the "
                    f"tp collectives' {route!r} route (ranks sharing a card "
                    "over gloo); use multi_tick=1 there, or one rank a card "
                    "over NCCL")
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
        # the family before a tp layout binds into it (rebuild_on_mesh
        # binds the new mesh's)
        self._family0 = self.family
        if mesh is None:
            self._params = _to_device(params, self.device)
        else:
            self._params = self._shard_params(params)
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
            self._cache = self._new_cache()
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
            # the three maps for each spec state: set_spec_drafts swaps
            # in the other state's, so each tick body keeps its graphs
            # (at most 2 captures a state)
            self._graph_sets = {bool(self.spec): (
                self._graphs, self._graph_out, self._graph_held)}
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
        # the K-tick dispatch captured and replayed; sampled_passes,
        # sampled_dispatches, sampled_captures: the prefill passes,
        # dispatches and captures that ran the sampler (one draw a pass,
        # K a dispatch)
        self.counters = {"prefills": 0, "decode_ticks": 0,
                         "tokens_emitted": 0, "quant_matmuls": 0,
                         "prefill_chunks": 0, "cow_copies": 0,
                         "prefix_hits": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "graph_captures": 0,
                         "graph_replays": 0, "sampled_passes": 0,
                         "sampled_dispatches": 0, "sampled_captures": 0}
        # fused dequant-matmuls per full forward: quantized leaves per
        # layer x depth + the head (the reference's formula); a spec
        # tick adds gamma draft passes of draft_layers layers + the head
        self._qmm_full = self._qmm_draft = 0
        if self._quant_info:
            per, head = self._quant_info["per_layer"], \
                self._quant_info["head"]
            self._qmm_full = per * n_layers + head
            self._qmm_draft = per * self.spec_draft_layers + head

        # the fault-injection multipliers of the target and draft logits:
        # ones, written in place (a CUDA graph reads their addresses)
        self._poison = torch.ones(n, dtype=torch.float32, device=self.device)
        self._dpoison = torch.ones(n, dtype=torch.float32,
                                   device=self.device)
        self._raise_cow = False          # injected cow_raise, armed
        self._raise_migrate = False      # injected migrate_raise, armed
        self._retired = False            # left its mesh (rebuild_on_mesh)
        self._actions: dict = {}         # the tick's injected faults
        # SLO samples (host ms): TTFT includes the queue wait; inter-token
        # latency a token, a multi-token pull's gap shared among them
        self._slo_ttft: collections.deque = collections.deque(maxlen=8192)
        self._slo_itl: collections.deque = collections.deque(maxlen=8192)
        # in-tick telemetry: the dispatch packs the TICK_FIELDS row beside
        # its tokens and the one pull carries both
        from ..profiler.serving_telemetry import (ServingTelemetry,
                                                  resolve_serving_telemetry)
        self._tick_tele = resolve_serving_telemetry(telemetry)
        self._tick_log = None
        if self._tick_tele:
            self._tick_log = ServingTelemetry(
                path=telemetry_jsonl, every=telemetry_every,
                meta={"family": self.family.name,
                      "layout": "paged" if self.paged else "dense",
                      "spec": bool(self.spec),
                      "quant": "int8" if self.quant else "off",
                      "multi_tick": self.mt_k, "tp": self.tp,
                      "num_slots": self.num_slots, "max_len": self.max_len})
        self._tracer = None
        if tracing:
            from ..profiler import tracing as _tracing
            self._tracer = _tracing.tracer()
        from ..profiler import flight_recorder
        self._flight = flight_recorder.recorder()
        self._puller = None            # the watchdog's worker, made lazily
        self._init_metrics()

    def _init_metrics(self) -> None:
        """The reference's serving.* monitor stats (process-global: a
        counter sums over engines; a gauge is the last engine's write)."""
        self._m_occ = monitor.gauge("serving.slot_occupancy")
        self._m_queue = monitor.gauge("serving.queue_depth")
        self._m_qwait = monitor.histogram("serving.queue_wait_ms")
        self._m_tok = monitor.counter("serving.tokens_emitted")
        self._m_pre = monitor.counter("serving.prefills")
        self._m_tick = monitor.counter("serving.decode_ticks")
        self._m_sub = monitor.counter("serving.requests_submitted")
        self._m_done = monitor.counter("serving.requests_completed")
        self._m_rej = monitor.counter("serving.rejected")
        self._m_retry = monitor.counter("serving.retries")
        self._m_fault = monitor.counter("serving.faults")
        self._reason_ctr = {
            r: monitor.counter(f"serving.{r}")
            for r in ("timeout", "cancelled", "poisoned", "evicted")}
        # the kv pool (0 under the dense layout)
        self._m_pages = monitor.gauge("serving.pages_in_use")
        self._m_shared = monitor.gauge("serving.pages_shared")
        self._m_cow = monitor.counter("serving.cow_copies")
        self._m_chunks = monitor.counter("serving.prefill_chunks")
        # the pool's device bytes: dense, the whole cache, set once;
        # paged, pages in use x a page's bytes
        self._m_kv_bytes = monitor.gauge("serving.kv_pool_bytes")
        self._m_oom = monitor.counter("serving.oom_forensics")
        kv_bytes = 2 * self._cache["k"].numel() * \
            self._cache["k"].element_size()
        if self.paged:
            self._page_bytes = kv_bytes // self.num_pages
            self._publish_pool_gauges()
        else:
            self._m_kv_bytes.set(kv_bytes)
        self._m_kv_host = monitor.gauge("serving.kv_host_bytes")
        self._m_ticks_pull = monitor.gauge("serving.ticks_per_pull")
        self._m_ticks_pull.set(self.mt_k)
        self._m_spill = monitor.counter("serving.host_spills")
        self._m_swapin = monitor.counter("serving.host_swapins")
        # speculative decode: the rate gauge is this engine's cumulative
        # accepted / proposed
        self._m_spec_prop = monitor.counter("serving.spec_proposed")
        self._m_spec_acc = monitor.counter("serving.spec_accepted")
        self._m_spec_rate = monitor.gauge("serving.spec_accept_rate")
        self._spec_prop_total = 0
        self._spec_acc_total = 0
        # weight-only int8: this engine's weight bytes before and after
        # the rewrite; the kernel's calls (K ticks' worth a dispatch)
        self._m_qw = monitor.gauge("serving.quant_weights_bytes")
        self._m_fpw = monitor.gauge("serving.fp_weights_bytes")
        self._m_qmm = monitor.counter("serving.quant_matmuls")
        if self._quant_info:
            self._m_qw.set(self._quant_info["quant_bytes"])
            self._m_fpw.set(self._quant_info["fp_bytes"])

    def _publish_pool_gauges(self) -> None:
        if not self.paged:
            return
        pages = int((self._pool.ref[1:] > 0).sum())
        self._m_pages.set(pages)
        self._m_shared.set(int((self._pool.ref[1:] > 1).sum()))
        self._m_kv_bytes.set(pages * self._page_bytes)

    def _publish_tier_gauges(self) -> None:
        """Host-side gauges, published each tick with the pool gauges (no
        device read)."""
        self._m_ticks_pull.set(self.mt_k)
        if self._host_tier is not None:
            self._m_kv_host.set(self._host_tier.bytes)

    def _new_cache(self) -> dict:
        """A zeroed cache of this engine's layout: the page pool with its
        table, or the dense slot cache."""
        if self.paged:
            return self._init_paged_cache()
        return self.family.init_cache(self.cfg, self.num_slots,
                                      self.max_len, device=self.device)

    # --------------------------------------------- tensor-parallel seams
    def _serving_table(self, params) -> dict:
        """The family's serving specs on this engine's tp axis, with a
        Llama k/v whole where tp does not divide its KV heads and the
        int8 leaves' specs (quantization/serving.py quant_specs)."""
        from ..parallel.mesh import P, remap_specs
        specs = dict(self.family.serving_specs)
        if self.tp_axis != "tp":
            specs = remap_specs(specs, {"tp": self.tp_axis})
        kv = int(getattr(self.cfg, "num_kv_heads", 0) or 0)
        if kv and kv % self.tp:
            group = self.cfg.num_heads // kv
            if group % (self.cfg.num_heads // self.tp):
                raise ValueError(
                    f"tp={self.tp}: the query heads of a rank "
                    f"({self.cfg.num_heads // self.tp}) straddle the "
                    f"groups of {group} that share a KV head; pick a tp "
                    f"that divides num_kv_heads={kv}, or one that puts "
                    "each rank's query heads inside one group")
            for name in ("k_w", "v_w"):
                specs[name] = P()
        if self._quant_info:
            from ..quantization.serving import quant_specs
            specs = quant_specs(specs, params)
        return specs

    def _shard_params(self, params) -> dict:
        """This rank's shard of every leaf of the FULL tree `params`
        (numpy arrays or tensors), by the serving table, shape-aware: a
        dim tp does not divide stays whole. `_param_pins` keeps each
        leaf's Sharding."""
        from ..models.convert import params_from_jax
        from ..parallel.layout import ServingLayout
        from ..parallel.mesh import P, sharding_for
        if self.cfg.num_heads % self.tp:
            raise ValueError(f"tp={self.tp} does not divide num_heads="
                             f"{self.cfg.num_heads} (head-sharded "
                             "attention); see plan_serving_tp")
        specs = self._serving_table(params)
        self._param_pins = {}
        self._full_shapes = {}
        out = {}
        for name, value in params.items():
            if not isinstance(value, torch.Tensor):
                value = params_from_jax({name: value}, "cpu")[name]
            pin = sharding_for(specs.get(name, P()), self.mesh,
                               shape=tuple(value.shape))
            self._param_pins[name] = pin
            self._full_shapes[name] = tuple(value.shape)
            value = self.family.serving_order(name, value, self.tp)
            out[name] = pin.shard(value).to(self.device)
        self._layout = ServingLayout(
            self.mesh, {k: v.spec for k, v in self._param_pins.items()},
            self.tp_axis)
        base = self.family
        self.family = dataclasses.replace(
            base, forward_cached=functools.partial(base.forward_cached,
                                                   layout=self._layout))
        self._pin_cache()
        return out

    def _pin_cache(self) -> None:
        """The cache leaves' Shardings (decode_attention.cache_pspecs,
        shape-aware on the head axis, the one the spec splits; the dense
        shape stands for either layout), and the family's cache factory
        bound to this rank's heads, so every cache the engine makes (the
        pool, a dense prefill's one-row cache, the paged probe) holds
        only them."""
        from ..kernels.decode_attention import cache_pspecs
        from ..parallel.mesh import P, sharding_for
        probe = self.family.init_cache(self.cfg, 1, 1, device="cpu")
        L, _, _, heads, hd = probe["k"].shape
        specs = cache_pspecs(self.paged, self.tp_axis)
        full = (L, self.num_slots, self.max_len, heads, hd)
        self._cache_pins = {
            k: sharding_for(specs[k], self.mesh, shape=full)
            for k in ("k", "v")}
        if self.paged:
            self._cache_pins["pt"] = sharding_for(P(), self.mesh)
        local = self._cache_pins["k"].local_shape(full)[3]
        self.family = dataclasses.replace(
            self.family, init_cache=functools.partial(
                self.family.init_cache, heads=local))

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
        # a slot mid-chunked-prefill holds a request but is not active;
        # a retired engine holds nothing
        return (bool(self._queue) or bool(self._active.any())
                or any(r is not None for r in self._slot_req))

    def tick_records(self) -> list:
        """The in-tick telemetry ring (serving_tick and serving_prefill
        records, newest last); empty with telemetry off."""
        return [] if self._tick_log is None else self._tick_log.records()

    def flush_telemetry(self, timeout: Optional[float] = None) -> None:
        """Block until every pending serving_tick record is on disk
        (no-op without telemetry_jsonl=)."""
        if self._tick_log is not None:
            self._tick_log.flush(timeout=timeout)

    def slo_snapshot(self) -> dict:
        """The raw SLO samples (ms): time to first token (queue wait
        included) and inter-token latency, bounded rings."""
        return {"ttft_ms": [round(v, 3) for v in self._slo_ttft],
                "itl_ms": [round(v, 3) for v in self._slo_itl]}

    def export_slo_jsonl(self, path: str) -> None:
        """Append one serving_slo record to a telemetry JSONL file and
        drain the sample rings, so a periodic export never counts a
        sample twice (tools/telemetry_report.py merges the records'
        samples into TTFT / inter-token p50/p95/p99)."""
        rec = {"kind": "serving_slo", "t": time.time(),
               **self.slo_snapshot()}
        self._slo_ttft.clear()
        self._slo_itl.clear()
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # --------------------------------------------------------- admission
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               deadline_ticks: Optional[int] = None,
               tenant: str = "default", priority: int = 0,
               _trace=None) -> Request:
        """Queue one request (prompt: 1-D int token ids). Returns the
        live Request; its .tokens fill in as the engine steps.
        `deadline_s` / `deadline_ticks` bound its whole lifetime (queue
        wait included) in wall seconds / engine ticks; past either it
        ends "timeout". At max_queue, "reject" raises BackpressureError
        and "shed_oldest" evicts the oldest queued request. `_trace`
        threads a caller's RequestTrace through (with tracing=True and
        none given the engine mints one)."""
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
        if self.max_queue > 0 and len(self._queue) >= self.max_queue:
            if self.queue_policy == "shed_oldest":
                self._finish(self._queue.popleft(), "evicted")
            else:
                self._m_rej.add()
                raise BackpressureError(
                    f"admission queue full ({len(self._queue)} waiting, "
                    f"max_queue={self.max_queue})",
                    queue_depth=len(self._queue))
        req = Request(self._next_id, prompt, int(max_new_tokens),
                      float(temperature), int(top_k), eos_id,
                      deadline_s=(None if deadline_s is None
                                  else float(deadline_s)),
                      deadline_ticks=(None if deadline_ticks is None
                                      else int(deadline_ticks)),
                      tenant=tenant, priority=priority)
        req.t_submit = time.perf_counter()
        req._tick_submit = self._ticks
        req._engine = self
        if _trace is not None:
            req.trace = _trace
        elif self._tracer is not None:
            req.trace = self._tracer.trace(
                f"request-{req.id}", request_id=req.id, prompt_len=t0,
                max_new_tokens=int(max_new_tokens))
        if req.trace is not None:
            req._sp_queue = req.trace.begin(
                "queue", queue_depth=len(self._queue),
                attempt=req.trace.attempt)
        self._next_id += 1
        self._queue.append(req)
        self._m_sub.add()
        self._m_queue.set(len(self._queue))
        return req

    # --------------------------------------------------------- the tick
    def step(self):
        """One engine tick: consult the fault hook, expire queued
        requests past their TTL or deadline, advance ONE mid-prefill
        slot by one chunk (paged), admit queued requests into free slots
        (one prefill each; under the paged layout only when the
        request's page reservation fits, else it waits at the head of
        the queue), advance every active slot through the decode
        dispatch (quarantining poisoned rows), then enforce deadlines on
        the survivors. Returns this tick's (request, token) emissions."""
        events: List[tuple] = []
        if self._retired:
            return events
        # this tick's injected faults, consumed by the guarded calls
        self._actions = {}
        if _FAULT_HOOK is not None:
            self._actions = _FAULT_HOOK(self._ticks) or {}
        if self.paged and self._actions.pop("raise_cow", None):
            self._raise_cow = True
        if self._actions.pop("raise_migrate", None):
            self._raise_migrate = True       # the next snapshot raises
        now = time.perf_counter()
        self._expire_queued(now)
        if self.paged:
            self._advance_prefill(events)
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                break
            head = self._queue[0]
            if self._deadline_expired(head, now):
                self._queue.popleft()
                self._finish(head, "timeout")
                continue
            if self.paged and (self._plan_admission(head)[4]
                               > self._pool.available()):
                # FCFS: the head waits for pages to free; its host-tier
                # pages upload meanwhile
                self._prefetch_host(head)
                break
            self._queue.popleft()
            self._admit_guarded(slot, head, events)
        if self._active.any():
            self._decode(events)
        # outside the decode branch: a slot mid-chunked-prefill honors
        # its deadline even while no stream decodes
        self._enforce_deadlines(time.perf_counter())
        self._ticks += 1
        self._m_occ.set(int(self._active.sum()))
        self._m_queue.set(len(self._queue))
        self._publish_pool_gauges()
        self._publish_tier_gauges()
        return events

    def drain(self, max_ticks: Optional[int] = None):
        """Step until idle (or max_ticks); returns all emissions. With
        max_ticks live requests may remain: `abort_pending()` (or
        `generate(..., max_ticks=)`, which calls it for its requests)
        resolves them."""
        events = []
        ticks = 0
        while self.has_work():
            events.extend(self.step())
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        return events

    def abort_pending(self, reason: str = "evicted") -> int:
        """Resolve every live request, queued and in a slot, with the
        terminal `reason`. Returns the number aborted."""
        if reason not in TERMINAL_REASONS:
            raise ValueError(f"reason {reason!r} not in "
                             f"{sorted(TERMINAL_REASONS)}")
        n = 0
        while self._queue:
            self._finish(self._queue.popleft(), reason)
            n += 1
        for req in list(self._slot_req):
            if req is not None:
                self._finish(req, reason)
                n += 1
        self._m_occ.set(int(self._active.sum()))
        self._m_queue.set(len(self._queue))
        return n

    def generate(self, prompts: Sequence, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 deadline_ticks: Optional[int] = None,
                 max_ticks: Optional[int] = None) -> List[np.ndarray]:
        """Submit every prompt, drain, and return each request's
        generated ids in submission order. What `max_ticks` (or a
        deadline) left undelivered resolves ("evicted") before
        returning: every request this call submitted is done."""
        reqs = [self.submit(p, max_new_tokens, temperature=temperature,
                            top_k=top_k, eos_id=eos_id,
                            deadline_s=deadline_s,
                            deadline_ticks=deadline_ticks)
                for p in prompts]
        self.drain(max_ticks)
        for r in reqs:
            if not r.done:
                if r.slot is None:
                    try:
                        self._queue.remove(r)
                    except ValueError:
                        pass
                self._finish(r, "evicted")
        self._m_queue.set(len(self._queue))
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

    def _rollback_slot(self, slot: int, req: Request, n_tok: int) -> None:
        """Undo a partial admission: the slot (its pages and reservation
        under the paged layout) and the request's progress return to
        their state before it, and the device state is marked stale."""
        if self._slot_req[slot] is req:
            self._clear_slot(slot)
        req.slot = None
        req._pf_next = None
        req.shared_tokens = 0
        del req.tokens[n_tok:]

    def _finish(self, req: Request, reason: str) -> None:
        """THE terminal transition, exactly once per request."""
        if req.done:
            return
        if req.slot is not None:
            self._clear_slot(req.slot)
        req.slot = None
        req.done = True
        req.finish_reason = reason
        if req.trace is not None:
            # the one terminal span (RequestTrace.finish is once-only)
            req.trace.finish(reason, tokens=len(req.tokens))
        self._m_done.add()
        ctr = self._reason_ctr.get(reason)
        if ctr is not None:
            ctr.add()

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
        self._m_queue.set(len(self._queue))
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
        """Quarantine one request on its non-finite logits."""
        self._on_fault("poisoned", RuntimeError(
            f"non-finite {where} logits (request {req.id})"))
        self._finish(req, "poisoned")

    # --------------------------------------------------------- deadlines
    def _deadline_expired(self, req: Request, now: float) -> bool:
        if (req.deadline_s is not None
                and now - req.t_submit >= req.deadline_s):
            return True
        return (req.deadline_ticks is not None
                and self._ticks - req._tick_submit >= req.deadline_ticks)

    def _expire_queued(self, now: float) -> None:
        if not self._queue:
            return
        keep: collections.deque = collections.deque()
        for req in self._queue:
            ttl_hit = (self.queue_ttl_s > 0.0
                       and now - req.t_submit >= self.queue_ttl_s)
            if ttl_hit or self._deadline_expired(req, now):
                self._finish(req, "timeout")
            else:
                keep.append(req)
        self._queue = keep

    def _enforce_deadlines(self, now: float) -> None:
        for req in list(self._slot_req):
            if req is not None and self._deadline_expired(req, now):
                self._finish(req, "timeout")

    # ----------------------------------------------- self-healing calls
    def _on_fault(self, kind: str, exc: BaseException) -> None:
        """Every serving fault leaves a flight dump (no-op without a
        flight directory) and a counter bump."""
        self._m_fault.add()
        self._flight.configure(last_serving_fault=f"{kind}: {exc}")
        self._flight.note(serving_fault=kind, tick=self._ticks,
                          error=str(exc))
        self._flight.dump(f"serving_{kind}_fault")
        print(f"[serving] {kind} fault at tick {self._ticks}: {exc}",
              file=sys.stderr, flush=True)

    def _backoff(self, attempt: int) -> None:
        self._m_retry.add()
        time.sleep(min(self.backoff_base * (2.0 ** attempt),
                       self.backoff_max))

    def _dump_oom_forensics(self, where: str, exc) -> None:
        """The out-of-memory black box, before the retry or reset runs:
        the memory ledger, a census of the engine's tensors (params,
        cache), the pool and quant stats and the live configuration.
        Best-effort: forensics never mask the failure."""
        try:
            from ..profiler.mem_audit import live_array_census
            census = live_array_census(
                trees={"params": self._params, "cache": self._cache})
            self._m_oom.add()
            self._flight.configure(oom_forensics={
                "where": where, "tick": self._ticks,
                "error": repr(exc)[:500], "ledger": self.memory_ledger(),
                "census": census["rows"],
                "live_bytes": census["total_bytes"],
                "other_bytes": census["other_bytes"],
                "pool": self.pool_stats(), "quant": self.quant_stats(),
                "config": {"layout": "paged" if self.paged else "dense",
                           "num_slots": self.num_slots,
                           "max_len": self.max_len, "tp": self.tp}})
            self._flight.note(oom_forensics=where, tick=self._ticks)
            self._flight.dump("oom_forensics")
        except Exception:                      # noqa: BLE001
            pass

    def _hard_reset(self, reason: str) -> None:
        """The last resort after an exhausted retry budget or a hung
        pull: every in-flight request ends "evicted" and the cache is
        reallocated; queued requests stay queued and admit into the
        fresh cache. The CUDA graphs baked the old cache's addresses, so
        they are dropped with it and captured again at the next dispatch
        of each sampling flag. Under the paged layout the pool starts
        fresh (its prefix map named the old pages); the host tier
        survives (its pages are functions of prompt and weights) and its
        eviction tap re-attaches."""
        for req in list(self._slot_req):
            if req is not None:
                self._finish(req, "evicted")
        if self.paged:
            self._pool = _PagePool(self.num_pages, self.page_size)
            if self._host_tier is not None:
                self._pool.on_evict = self._spill_page
            self._host_stage.clear()
            self._ptab[:] = 0
            self._slot_reserve[:] = 0
            self._prefilling.clear()
            self._pt_dirty = False
        self._drop_graphs()
        self._cache = None               # frees the old cache first
        self._cache = self._new_cache()
        self._dstate = None
        self._dirty = True
        self._flight.configure(last_serving_fault=f"hard_reset: {reason}")
        self._flight.dump("serving_hard_reset")
        print(f"[serving] hard reset at tick {self._ticks} ({reason}): "
              "cache reallocated", file=sys.stderr, flush=True)

    def _pull(self, value, stall_s: float = 0.0):
        """THE device-to-host pull of every prefill and every dispatch:
        one int32 tensor (a dispatch's tokens with its TICK_FIELDS row
        packed beside them) to a numpy array, under the watchdog when
        `watchdog_timeout` > 0 (parallel/resilience.WatchdogPuller: the
        same pull re-polled with backoff, never re-dispatched). The copy
        runs on the caller's current stream whichever thread performs
        it, so it orders after every launch and replay before it.
        `stall_s` is the injected tick_stall: it sleeps inside the
        watched pull."""
        stream = (torch.cuda.current_stream(self.device)
                  if value.device.type == "cuda" else None)

        def src():
            if stall_s > 0.0:
                time.sleep(stall_s)
            if stream is None:
                return value.cpu().numpy()
            with torch.cuda.stream(stream):
                return value.cpu().numpy()
        if self.watchdog_timeout > 0.0:
            if self._puller is None:
                from ..parallel.resilience import WatchdogPuller
                self._puller = WatchdogPuller(label="serving tick")
            return self._puller.pull(
                src, self.watchdog_timeout, self.retries,
                self.backoff_base, self.backoff_max,
                on_retry=self._on_stall_retry)
        return src()

    def _on_stall_retry(self, attempt: int) -> None:
        """The watchdog's backoff observer: count it, and leave a flight
        dump at a tick's first stall (a pull that needed backoff is
        worth a post-mortem even when it recovers)."""
        self._m_retry.add()
        self._flight.note(serving_stall_attempt=attempt, tick=self._ticks)
        if attempt == 0:
            self._flight.dump("serving_stall")

    def _admit_guarded(self, slot: int, req: Request,
                       events: list) -> None:
        """Admission under the fault guard: a raising prefill rolls the
        slot back and retries with backoff; an exhausted budget resolves
        the request "evicted", never limbo. A hung pull is not
        retryable (re-waiting the budget can only fail again): the
        request is evicted and the engine hard-resets."""
        from ..parallel.resilience import StepHungError
        n_tok = len(req.tokens)
        for attempt in range(self.retries + 1):
            try:
                if self._actions.pop("raise_prefill", None):
                    raise ServingFaultError("injected prefill fault")
                self._admit(slot, req, events)
                return
            except StepHungError as e:
                self._rollback_slot(slot, req, n_tok)
                self._on_fault("prefill_hang", e)
                self._finish(req, "evicted")
                self._hard_reset("prefill watchdog hang")
                return
            except Exception as e:                 # noqa: BLE001
                self._rollback_slot(slot, req, n_tok)
                if _is_oom(e):
                    self._dump_oom_forensics("prefill", e)
                self._on_fault("prefill", e)
                if attempt >= self.retries:
                    self._finish(req, "evicted")
                    return
                self._backoff(attempt)

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
        if req.trace is not None:
            req.trace.end(req._sp_queue)
            req._sp_queue = None
            sp_pf = req.trace.begin("prefill", slot=slot, true_len=t0,
                                    bucket=tb, attempt=req.trace.attempt)
        t_pf0 = time.perf_counter()
        with RecordEvent("serving.prefill"):
            first = _prefill_slot(
                self._params, self._cache, self._upload(padded), t0, slot,
                self._upload([req.temperature], torch.float32),
                self._upload([req.top_k], torch.int32),
                self._upload([req.id], torch.int32), self.seed,
                fwd=self.family.forward_cached,
                init_cache=self.family.init_cache, cfg=self.cfg,
                max_top_k=self.max_top_k, sampling=req.temperature > 0.0,
                guard=self.guardrails)
            # the admission's one host pull, under the tick's watchdog
            tok = int(self._pull(first))
        pf_ms = (time.perf_counter() - t_pf0) * 1e3
        self.prefill_ms.append(pf_ms)
        if req.trace is not None:
            req.trace.end(sp_pf, final=True)
        if self._tick_log is not None:
            self._tick_log.record_prefill(self._ticks, pf_ms, t0, tb, True,
                                          slot)
        self.counters["prefills"] += 1
        self.counters["sampled_passes"] += req.temperature > 0.0
        self._count_qmm(self._qmm_full)
        self._m_pre.add()
        if tok < 0:
            # never activated: the slot's cache row is masked garbage
            # until the next occupant's prefill overwrites it
            self._poisoned(req, "prefill")
            return
        self._activate_slot(slot, req, tok, events)

    def _count_qmm(self, n: int) -> None:
        self.counters["quant_matmuls"] += n
        if n:
            self._m_qmm.add(n)

    def _activate_slot(self, slot: int, req: Request, tok: int,
                       events: list) -> None:
        """Prefill done: emit the first token, arm the host mirrors and
        hand the slot to the decode tick."""
        now = time.perf_counter()
        self._m_qwait.observe((now - req.t_submit) * 1e3)
        self._slo_ttft.append((now - req.t_submit) * 1e3)
        req._t_last = now
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
        if req.trace is not None:
            req._sp_decode = req.trace.begin(
                "decode", slot=slot, attempt=req.trace.attempt)
            req.trace.instant("decode.tick", parent=req._sp_decode,
                              tick=self._ticks, token=tok)
        req.tokens.append(tok)
        events.append((req, tok))
        self.counters["tokens_emitted"] += 1
        self._m_tok.add()
        self._maybe_finish(req)

    def _decode(self, events: list) -> None:
        """One decode dispatch under the fault guard. The host mirrors
        advance only after a successful pull, so a failed attempt marks
        the device state stale (the next dispatch reloads `_dstate` or
        the static buffers from the mirrors) and re-runs: the same state
        writes the same K/V at the same positions. A hung pull or an
        exhausted budget hard-resets."""
        from ..parallel.resilience import StepHungError
        actions = self._actions
        poison_slot = actions.pop("poison_slot", None)
        draft_slot = actions.pop("draft_poison_slot", None)
        stall_s = actions.pop("stall_s", 0.0)
        for attempt in range(self.retries + 1):
            try:
                if actions.pop("raise_decode", None):
                    raise ServingFaultError("injected decode fault")
                if actions.pop("raise_oom", None):
                    # the backend's marker in the message: the forensics
                    # below take the path a real allocation failure takes
                    raise ServingFaultError(
                        "injected allocation failure: "
                        "RESOURCE_EXHAUSTED: simulated out of memory")
                if self.paged:
                    # every active slot's write pages for the whole
                    # dispatch exist and are private before it scatters
                    # into them (a retry finds them allocated)
                    self._prepare_tick_pages()
                    self._sync_page_table()
                sampling = bool(np.any(self._temps[self._active] > 0.0))
                t_dev0 = time.perf_counter()
                with RecordEvent("serving.decode_tick"):
                    armed = self._arm_poison(poison_slot, draft_slot)
                    poison_slot = draft_slot = None   # injected once
                    try:
                        out = self._dispatch(sampling)
                    finally:
                        if armed:
                            # in stream order: after the dispatch read it
                            self._poison.fill_(1.0)
                            self._dpoison.fill_(1.0)
                    flat = self._pull(out, stall_s)
                tick_ms = (time.perf_counter() - t_dev0) * 1e3
                break
            except StepHungError as e:
                # the pull may still land later; re-polling already spent
                # the budget
                self._on_fault("decode_hang", e)
                self._hard_reset("watchdog hang")
                return
            except Exception as e:                 # noqa: BLE001
                self._dirty = True        # reload the device state
                if _is_oom(e):
                    self._dump_oom_forensics("decode", e)
                self._on_fault("decode", e)
                if attempt >= self.retries:
                    self._hard_reset("decode retries exhausted")
                    return
                self._backoff(attempt)
        # ONE host pull per dispatch: the [N, K] emission matrix (K
        # blocks of gamma+1 columns under spec decode), the TICK_FIELDS
        # row after it with telemetry on
        row = None
        if self._tick_tele:
            flat, row = flat[:-len(TICK_FIELDS)], flat[-len(TICK_FIELDS):]
        toks = flat.reshape(self.num_slots, -1)
        self.tick_ms.append(tick_ms)
        self.counters["decode_ticks"] += 1
        self.counters["sampled_dispatches"] += sampling
        self._count_qmm(self.mt_k * (
            self._qmm_full
            + (self.spec_gamma * self._qmm_draft if self.spec else 0)))
        self._m_tick.add()
        if self._tick_log is not None:
            host = {"queue_depth": len(self._queue)}
            if self.paged:
                host["prefilling"] = len(self._prefilling)
                host["pages_in_use"] = int((self._pool.ref[1:] > 0).sum())
            self._tick_log.record_tick(self._ticks, row, host, tick_ms)
        tick_now = time.perf_counter()
        if self.spec:
            self._apply_spec_emissions(toks, events, tick_now)
        else:
            self._apply_multi_emissions(toks, events, tick_now)

    def _tick_kw(self, sampling: bool) -> dict:
        kw = dict(fwd=self.family.forward_cached, cfg=self.cfg,
                  max_top_k=self.max_top_k, sampling=sampling,
                  guard=self.guardrails,
                  oor_pos=(self.max_pages * self.page_size if self.paged
                           else None), tele=self._tick_tele)
        if self.spec:
            kw.update(gamma=self.spec_gamma,
                      draft_layers=self.spec_draft_layers)
        return kw

    def _arm_poison(self, poison_slot, draft_slot) -> bool:
        """An injected nan_logits / draft_nan: nan into one lane of the
        target's poison multiplier (under guardrails) or the draft's
        (under spec decode), for the next dispatch; True when armed."""
        armed = False
        if poison_slot is not None and self.guardrails:
            self._poison[int(poison_slot) % self.num_slots] = float("nan")
            armed = True
        if draft_slot is not None and self.spec:
            self._dpoison[int(draft_slot) % self.num_slots] = float("nan")
            armed = True
        return armed

    def _dispatch(self, sampling: bool):
        """Run one dispatch on the device; returns the int32 tensor the
        one pull fetches: the emission matrix, with the TICK_FIELDS row
        after it under telemetry. K = 1: the eager tick over `_dstate`,
        re-uploaded from the host mirrors when dirty. K >= 2: the K-tick
        function over the static buffers, eagerly on the CPU; on the
        card the first dispatch of each `sampling` flag runs it eagerly
        on a side stream and then captures it in a CUDA graph, and every
        later one replays that graph."""
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
                out = spec_tick(
                    self._params, self._cache, self._dstate, self.seed,
                    self._poison, self._dpoison, **self._tick_kw(sampling))
            else:
                out = _decode_tick(
                    self._params, self._cache, self._dstate, self.seed,
                    self._poison, **self._tick_kw(sampling))
            self._dstate = out[-1]
            return _packed(out[:-1])
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
        with _CAPTURE_LOCK:
            side = _CAPTURE_STREAMS.get(self.device.index)
            if side is None:
                side = _CAPTURE_STREAMS[self.device.index] = \
                    torch.cuda.Stream(self.device)
            main = torch.cuda.current_stream(self.device)
            # the warm-up: a real dispatch, eagerly on the capture's
            # stream, which also sizes every workspace the graph will bake
            side.wait_stream(main)
            with torch.cuda.stream(side):
                emit = self._multi_ticks(sampling)
            main.wait_stream(side)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            # thread-local: a router's other threads keep launching and
            # pulling on their own streams while this one captures
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out = self._multi_ticks(sampling)    # recorded, not run
            self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        self._graphs[sampling] = graph
        self._graph_out[sampling] = out
        # the memoized tensors the capture just read (the RoPE tables):
        # held here, so no eviction can free an address the graph baked
        self._graph_held[sampling] = self.family.held_tensors(self.cfg,
                                                              self._cache)
        self.counters["graph_captures"] += 1
        self.counters["sampled_captures"] += sampling
        return emit

    def _multi_ticks(self, sampling: bool):
        """The K-tick function over the static buffers: the ticks, then
        the advanced state copied back into the buffers in place (the
        body a CUDA graph captures). Returns the packed emission matrix
        (and TICK_FIELDS row), so under a graph the row is one of the
        graph's outputs."""
        from .multi_tick import multi_tick_spec_ticks, multi_tick_ticks
        state, (eos_ids, max_new) = self._gbufs[:7], self._gbufs[7:]
        if self.spec:
            out = multi_tick_spec_ticks(
                self._params, self._cache, state, self.seed, eos_ids,
                max_new, self._poison, self._dpoison, k_ticks=self.mt_k,
                max_len=self.max_len, **self._tick_kw(sampling))
        else:
            out = multi_tick_ticks(
                self._params, self._cache, state, self.seed, eos_ids,
                max_new, self._poison, k_ticks=self.mt_k,
                max_len=self.max_len, **self._tick_kw(sampling))
        for buf, val in zip(state, out[-1]):
            buf.copy_(val)
        return _packed(out[:-1])

    def _emit_token(self, i: int, req: Request, tok: int, events: list,
                    tick_now: float, itl_ms: Optional[float] = None) -> None:
        """Mirror exactly what the tick did on the device (position and
        token index advanced under the active mask), record the token
        and its SLO sample, run the finish checks. `itl_ms` replaces the
        wall-clock inter-token sample where a pull carried several of a
        slot's tokens: the caller shares the gap among them."""
        self._positions[i] += 1
        self._cur_tok[i] = tok
        self._gen_idx[i] += 1
        if req.trace is not None:
            req.trace.instant("decode.tick", parent=req._sp_decode,
                              tick=self._ticks, token=tok)
        req.tokens.append(tok)
        events.append((req, tok))
        self.counters["tokens_emitted"] += 1
        self._m_tok.add()
        self._slo_itl.append((tick_now - req._t_last) * 1e3
                             if itl_ms is None else itl_ms)
        req._t_last = tick_now
        self._maybe_finish(req)

    def _apply_multi_emissions(self, toks, events: list,
                               tick_now: float) -> None:
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
            row = toks[i].tolist()
            if MT_PAD in row:
                row = row[:row.index(MT_PAD)]
            share = None
            if self.mt_k > 1:
                share = (tick_now - req._t_last) * 1e3 / max(
                    sum(1 for t in row if t >= 0), 1)
            for tok in row:
                if tok < 0:
                    self._poisoned(req, "decode")
                    break
                self._emit_token(i, req, tok, events, tick_now,
                                 itl_ms=share)
                if req.done:
                    break

    def _apply_spec_emissions(self, toks, events: list,
                              tick_now: float) -> None:
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
            emit, poisoned, blocks = [], False, 0
            for b in range(0, len(flat), width):
                row = flat[b:b + width]
                if b and row[0] == SPEC_PAD:
                    break
                blocks += 1
                if row[0] < 0:
                    poisoned = True
                    break
                cut = row.index(SPEC_PAD) if SPEC_PAD in row else len(row)
                if self._temps[i] <= 0.0:    # sampled slots never propose
                    self.counters["spec_proposed"] += self.spec_gamma
                    self.counters["spec_accepted"] += cut - 1
                    self._spec_prop_total += self.spec_gamma
                    self._spec_acc_total += cut - 1
                    self._m_spec_prop.add(self.spec_gamma)
                    self._m_spec_acc.add(cut - 1)
                emit.extend(row[:cut])
            # a multi-block pull shares the dispatch gap among its tokens
            share = ((tick_now - req._t_last) * 1e3 / max(len(emit), 1)
                     if blocks > 1 else None)
            for tok in emit:
                self._emit_token(i, req, tok, events, tick_now,
                                 itl_ms=share)
                if req.done:
                    break
            if poisoned and not req.done:
                self._poisoned(req, "decode")
        if self._spec_prop_total:
            self._m_spec_rate.set(self._spec_acc_total
                                  / self._spec_prop_total)
        if self.paged:
            for i in np.nonzero(self._active)[0]:
                self._rollback_spec_pages(int(i))

    # ------------------------------------------------------ fleet seams
    def set_spec_drafts(self, enabled: bool) -> bool:
        """Toggle speculative drafts live (the brownout ladder's first
        lever): off runs the plain tick, and greedy streams are the same
        either way, so the switch frees capacity with nothing
        user-visible. Only an engine built with spec on can turn them
        back on (`enabled=True` is a no-op otherwise). Under multi-tick
        on the card each state keeps its own CUDA graphs, so the first
        flip each way captures once a sampling flag (4 captures at most,
        then replays). Returns the live spec flag."""
        want = bool(enabled) and self._spec_capable
        if want == self.spec:
            return self.spec
        self.spec = want
        self._tick_span = self.mt_k * ((self.spec_gamma + 1) if want
                                       else 1)
        if self.mt_k > 1:
            self._graphs, self._graph_out, self._graph_held = \
                self._graph_sets.setdefault(want, ({}, {}, {}))
        return self.spec

    def _drop_graphs(self) -> None:
        """Every CUDA graph of every spec state (they baked the cache's
        addresses)."""
        if self.mt_k > 1:
            for maps in self._graph_sets.values():
                for m in maps:
                    m.clear()

    def snapshot_request(self, req: Request) -> Optional[dict]:
        """The live state of a mid-decode request, on the host, for
        migration to another engine: the K/V of every written position
        as one layout-neutral [L, pos, heads, hd] block a side (dense:
        the slot's rows; paged: its pages gathered through the page
        table on the device), pulled once, in the cache's dtype, and the
        decode-state mirror (pos, cur_tok, gen_idx and the PRNG id, so a
        sampled stream continues to the bit). A tensor-parallel engine
        snapshots its rank's heads. None when there is nothing to
        migrate: the request is terminal, queued or mid-chunked-prefill.
        Call between ticks. Raises ServingFaultError under the injected
        migrate_raise."""
        slot = req.slot
        if (req.done or slot is None or req._pf_next is not None
                or not self._active[slot]):
            return None
        if self._raise_migrate:
            self._raise_migrate = False
            raise ServingFaultError("injected migrate fault")
        pos = int(self._positions[slot])
        ck, cv = self._cache["k"], self._cache["v"]
        if self.paged:
            ps = self.page_size
            npg = -(-pos // ps)
            pids = self._upload(self._ptab[slot, :npg])
            # [L, npg, ps, heads, hd] -> the position-ordered prefix
            kv = torch.stack([ck.index_select(1, pids),
                              cv.index_select(1, pids)])
            kv = kv.reshape(2, ck.shape[0], npg * ps,
                            *ck.shape[3:])[:, :, :pos]
        else:
            kv = torch.stack([ck[:, slot, :pos], cv[:, slot, :pos]])
        kv = kv.cpu()                      # the snapshot's one pull
        k, v = kv[0], kv[1]
        return {"prompt": np.asarray(req.prompt, np.int32),
                "tokens": list(req.tokens),
                "max_new_tokens": int(req.max_new_tokens),
                "temperature": float(req.temperature),
                "top_k": int(req.top_k),
                "eos_id": req.eos_id,
                "tenant": req.tenant,
                "priority": req.priority,
                "pos": pos,
                "cur_tok": int(self._cur_tok[slot]),
                "gen_idx": int(self._gen_idx[slot]),
                "prng_id": int(self._req_ids[slot]),
                "kv_k": k, "kv_v": v,
                "kv_bytes": 2 * k.numel() * k.element_size()}

    def restore_request(self, snap: dict,
                        deadline_s: Optional[float] = None,
                        deadline_ticks: Optional[int] = None,
                        _trace=None) -> Optional[Request]:
        """Admit a migrated snapshot into this engine, past the queue
        (the request is mid-flight): a free slot is claimed directly, a
        paged restore reserves the request's remaining worst-case page
        envelope through the admission accounting (the pages holding the
        snapshot allocate now, the rest reserve), and the K/V uploads
        with zero re-prefilled tokens. Deadlines are the remaining
        budget (the caller re-scopes them). Returns the new live Request,
        its .tokens seeded with the ids already generated, or None when
        this engine cannot take it (no free slot or pages, shape
        limits): the caller falls back to requeue-replay."""
        prompt = np.asarray(snap["prompt"], np.int32).reshape(-1)
        t0 = prompt.shape[0]
        max_new = int(snap["max_new_tokens"])
        if self._retired or t0 + max_new > self.max_len:
            return None
        if snap["top_k"] > self.max_top_k:
            return None
        slot = self._free_slot()
        if slot is None:
            return None
        if self.paged:
            need = self._pages_needed(t0, max_new)
            if need > self._pool.available():
                return None
        req = Request(self._next_id, prompt, max_new,
                      float(snap["temperature"]), int(snap["top_k"]),
                      snap["eos_id"],
                      deadline_s=(None if deadline_s is None
                                  else float(deadline_s)),
                      deadline_ticks=(None if deadline_ticks is None
                                      else int(deadline_ticks)),
                      tenant=str(snap.get("tenant", "default")),
                      priority=int(snap.get("priority", 0)))
        self._next_id += 1
        req.t_submit = time.perf_counter()
        req._tick_submit = self._ticks
        req._engine = self
        req.tokens = list(snap["tokens"])
        req.trace = _trace
        self._restore_into(req, snap, slot)
        self._m_sub.add()
        return req

    def _restore_into(self, req: Request, snap: dict, slot: int) -> None:
        """Write a snapshot's K/V into `slot` and arm every host mirror:
        the shared tail of a cross-engine restore and of the mesh
        rebuild. The K/V goes into the existing cache tensors in place
        (`copy_` / `index_copy_`), never a new cache: a multi-tick
        engine's CUDA graphs baked the cache's addresses, so a restored
        stream continues inside their replays with no new capture. The
        PRNG mirror carries the source engine's id, so a sampled
        continuation is the undisturbed engine's."""
        pos = int(snap["pos"])
        ck, cv = self._cache["k"], self._cache["v"]
        kv_k = torch.as_tensor(snap["kv_k"]).to(self.device, ck.dtype)
        kv_v = torch.as_tensor(snap["kv_v"]).to(self.device, cv.dtype)
        if self.paged:
            ps = self.page_size
            npg = -(-pos // ps)
            need = self._pages_needed(len(req.prompt),
                                      req.max_new_tokens)
            L = kv_k.shape[0]
            pids = []
            for j in range(npg):
                pid = self._pool.alloc()
                self._ptab[slot, j] = pid
                pids.append(pid)
            idx = self._upload(pids, torch.int64)
            for cache, kv in ((ck, kv_k), (cv, kv_v)):
                pad = torch.zeros((L, npg * ps) + tuple(kv.shape[2:]),
                                  dtype=cache.dtype, device=self.device)
                pad[:, :pos] = kv
                cache.index_copy_(1, idx, pad.reshape(
                    (L, npg, ps) + tuple(kv.shape[2:])))
            reserve = max(need - npg, 0)
            self._slot_reserve[slot] = reserve
            self._pool.reserved += reserve
            self._pt_dirty = True
        else:
            ck[:, slot, :pos].copy_(kv_k)
            cv[:, slot, :pos].copy_(kv_v)
        now = time.perf_counter()
        req.slot = slot
        req._t_last = now
        self._slot_req[slot] = req
        self._positions[slot] = pos
        self._active[slot] = True
        self._cur_tok[slot] = int(snap["cur_tok"])
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._req_ids[slot] = int(snap["prng_id"])
        self._gen_idx[slot] = int(snap["gen_idx"])
        self._eos_ids[slot] = (-1 if req.eos_id is None
                               else int(req.eos_id))
        self._max_new[slot] = int(req.max_new_tokens)
        self._dirty = True
        if req.trace is not None:
            req._sp_decode = req.trace.begin(
                "decode", slot=slot, migrated=True,
                attempt=req.trace.attempt)

    def detach_request(self, req: Request) -> bool:
        """Non-terminal release, the migration seam: drop `req` from this
        engine (slot, pages, reservation, queue) without the terminal
        transition, since it continues on another engine: its trace stays
        open (only the decode span closes) and no terminal-reason counter
        fires. finish_reason is the sentinel "migrated", not in
        TERMINAL_REASONS. requests_completed still advances, so
        submitted - completed stays the in-flight count. False when the
        request already resolved."""
        if req.done:
            return False
        if req.slot is not None:
            self._clear_slot(req.slot)
        else:
            try:
                self._queue.remove(req)
            except ValueError:
                pass
        req.slot = None
        req.done = True
        req.finish_reason = "migrated"
        if req.trace is not None and req._sp_decode is not None:
            req.trace.end(req._sp_decode)
            req._sp_decode = None
        self._m_done.add()
        self._m_occ.set(int(self._active.sum()))
        self._m_queue.set(len(self._queue))
        return True

    def rebuild_on_mesh(self, mesh) -> int:
        """Preemption recovery of a tensor-parallel engine: every rank of
        the old mesh calls this together with the survivors' `mesh`
        (built on every rank of the world: forming it is collective).
        Each live slot snapshots its rank's heads; while the old tp group
        is still whole, the ranks gather over it the snapshots' missing
        KV heads and every parameter shard, so a survivor holds the full
        K/V and the full (int8) tree; then a survivor re-cuts its shards
        for the new mesh (`_shard_params`), allocates a fresh cache for
        its new heads, drops its CUDA graphs, and restores the snapshots
        in place onto the same Request objects: callers' handles keep
        filling, zero re-prefilled tokens. Requests mid-chunked-prefill
        end "evicted"; queued requests stay queued and prefill on the new
        mesh. A rank outside `mesh` retires its engine: its requests
        leave ("migrated": they live on in the survivors' copies),
        `has_work()` is False, and it returns 0. Else returns the number
        of live streams moved."""
        from ..parallel.collective import all_gather
        from ..parallel.mesh import (_entry_axes, axis_group, axis_names,
                                     axis_size)
        if self.mesh is None:
            raise ValueError("rebuild_on_mesh needs a tp-sharded engine "
                             "(mesh=)")
        if self.tp_axis not in axis_names(mesh):
            raise ValueError(f"mesh {dict(zip(axis_names(mesh), mesh.shape))}"
                             f" has no {self.tp_axis!r} axis")
        if self.family.serving_specs is None:
            raise ValueError(
                f"family {self.family.name!r} has no "
                "SERVING_PARAM_SPECS — it cannot run tensor-parallel")

        def split_dim(spec):
            for d, e in enumerate(spec):
                if self.tp_axis in _entry_axes(e):
                    return d
            return None
        snaps = []
        for req in list(self._slot_req):
            if req is None:
                continue
            try:
                snap = self.snapshot_request(req)
            except Exception as e:             # noqa: BLE001
                self._on_fault("migrate", e)
                snap = None
            if snap is None:
                self._finish(req, "evicted")
            else:
                self._clear_slot(req.slot)     # the old pool's accounting
                req.slot = None
                snaps.append((req, snap))
        # over the old group while it is whole: the snapshots' heads and
        # every leaf, in one order on every rank
        old = axis_group(self.mesh, self.tp_axis)
        old_tp = self.tp
        heads_dim = split_dim(self._cache_pins["k"].spec)
        if old is not None and heads_dim is not None:
            for _, snap in snaps:
                for key in ("kv_k", "kv_v"):
                    # [L, pos, heads, hd]: the dense cache's head axis
                    # less its slot axis
                    snap[key] = all_gather(snap[key].to(self.device), old,
                                           dim=heads_dim - 1).cpu()
        full = {}
        for name, value in self._params.items():
            d = split_dim(self._param_pins[name].spec)
            if old is not None and d is not None:
                value = all_gather(value, old, dim=d)
            # undo the family's stored column order (GPT's head-grouped
            # qkv): the permutation the order applies to the columns
            cols = torch.arange(value.shape[-1], device=value.device)
            perm = self.family.serving_order(name, cols[None], old_tp)[0]
            if not torch.equal(perm, cols):
                value = value.index_select(value.dim() - 1,
                                           torch.argsort(perm))
            full[name] = value
        self._params = None
        self._cache = None
        self._drop_graphs()
        self._dstate = None
        self._dirty = True
        if mesh.get_coordinate() is None:
            return self._retire(snaps, mesh)
        self.mesh = mesh
        self.tp = axis_size(mesh, self.tp_axis)
        self.family = self._family0
        self._params = self._shard_params(full)
        del full
        if self.paged:
            self._pool = _PagePool(self.num_pages, self.page_size)
            if self._host_tier is not None:
                self._pool.on_evict = self._spill_page
            self._host_stage.clear()
            self._ptab[:] = 0
            self._slot_reserve[:] = 0
            self._prefilling.clear()
            self._pt_dirty = False
        self._cache = self._new_cache()
        kv_bytes = 2 * self._cache["k"].numel() * \
            self._cache["k"].element_size()
        if self.paged:
            self._page_bytes = kv_bytes // self.num_pages
        else:
            self._m_kv_bytes.set(kv_bytes)
        heads_dim = split_dim(self._cache_pins["k"].spec)
        for req, snap in snaps:
            if heads_dim is not None:
                # this rank's heads of the new mesh
                pin = self._cache_pins["k"]
                i, n = pin.local_index()[heads_dim]
                for key in ("kv_k", "kv_v"):
                    t = snap[key]
                    h = t.shape[2] // n
                    snap[key] = t.narrow(2, i * h, h)
            self._restore_into(req, snap, self._free_slot())
        self._publish_pool_gauges()
        self._flight.note(serving_rebuild={self.tp_axis: self.tp},
                          tick=self._ticks, migrated=len(snaps))
        self._flight.dump("serving_rebuild")
        print(f"[serving] rebuilt on mesh {{{self.tp_axis!r}: {self.tp}}} "
              f"at tick {self._ticks}: {len(snaps)} live stream(s) "
              "migrated", file=sys.stderr, flush=True)
        return len(snaps)

    def _retire(self, snaps, mesh) -> int:
        """This rank left the mesh: its live and queued requests leave
        the engine without a terminal reason (each lives on in a
        survivor's copy of the same scheduler), and the engine holds
        nothing from here on."""
        for req, _ in snaps:
            req.done = True
            req.finish_reason = "migrated"
            if req.trace is not None and req._sp_decode is not None:
                req.trace.end(req._sp_decode)
                req._sp_decode = None
            self._m_done.add()
        while self._queue:
            self.detach_request(self._queue[0])
        self.mesh = mesh
        self._retired = True
        self._m_occ.set(0)
        self._m_queue.set(0)
        self._flight.note(serving_retired=True, tick=self._ticks,
                          left=len(snaps))
        print(f"[serving] left the mesh at tick {self._ticks}: engine "
              "retired", file=sys.stderr, flush=True)
        return 0

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
                self._m_swapin.add()
        if matched:
            self._pt_dirty = True
        self.counters["prefix_hits"] += len(matched)
        req.shared_tokens = suffix_start
        req._pf_next = suffix_start
        if req.trace is not None:
            req.trace.end(req._sp_queue, shared_tokens=suffix_start)
            req._sp_queue = None
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
        sp_pf = None
        if req.trace is not None:
            sp_pf = req.trace.begin("prefill", slot=slot, chunk_start=start,
                                    chunk_len=clen, bucket=cb, final=final,
                                    attempt=req.trace.attempt)
        t_pf0 = time.perf_counter()
        with RecordEvent("serving.prefill"):
            first = _prefill_chunk(
                self._params, self._cache, self._upload(padded), clen,
                start, slot, self._upload([req.temperature], torch.float32),
                self._upload([req.top_k], torch.int32),
                self._upload([req.id], torch.int32), self.seed,
                fwd=self.family.forward_cached, cfg=self.cfg,
                max_top_k=self.max_top_k,
                sampling=final and req.temperature > 0.0,
                guard=self.guardrails)
            # the final chunk's one host pull
            tok = int(self._pull(first)) if final else None
        pf_ms = (time.perf_counter() - t_pf0) * 1e3
        self.prefill_ms.append(pf_ms)
        if req.trace is not None:
            req.trace.end(sp_pf)
        if self._tick_log is not None:
            self._tick_log.record_prefill(self._ticks, pf_ms, clen, cb,
                                          final, slot)
        self.counters["prefill_chunks"] += 1
        self.counters["sampled_passes"] += final and req.temperature > 0.0
        self._count_qmm(self._qmm_full)
        self._m_chunks.add()
        if not final:
            req._pf_next = end
            return
        req._pf_next = None
        self.counters["prefills"] += 1
        self._m_pre.add()
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
            self._chunk_guarded(slot, req, events)
            if req.done or req._pf_next is None:
                if self._prefilling and self._prefilling[0] == slot:
                    self._prefilling.popleft()
            return

    def _chunk_guarded(self, slot: int, req: Request,
                       events: list) -> None:
        """One chunk under the fault guard. A chunk re-run writes the
        same K/V into the same pages, so a raising call retries with
        backoff; an exhausted budget evicts the request (its pages free
        in `_clear_slot`), a hung pull hard-resets."""
        from ..parallel.resilience import StepHungError
        for attempt in range(self.retries + 1):
            try:
                if self._actions.pop("raise_prefill", None):
                    raise ServingFaultError("injected prefill fault")
                self._run_chunk(slot, req, events)
                return
            except StepHungError as e:
                self._on_fault("prefill_hang", e)
                self._finish(req, "evicted")
                self._hard_reset("prefill watchdog hang")
                return
            except Exception as e:                 # noqa: BLE001
                if _is_oom(e):
                    self._dump_oom_forensics("prefill", e)
                self._on_fault("prefill", e)
                if attempt >= self.retries:
                    self._finish(req, "evicted")
                    return
                self._backoff(attempt)

    # ---------------------------------------------------- host KV tier
    def _spill_page(self, pid: int, key) -> None:
        """The pool's on_evict tap: copy the evicting registered page to
        the host tier before its prefix entry drops. A registered page is
        immutable (COW), so the copy is bit-equal to what a device hit
        would read. A key the tier holds already (a page that went host,
        device and is evicted again) is not copied twice."""
        if key not in self._host_tier and self._host_tier.put(
                key, self._cache["k"][:, pid], self._cache["v"][:, pid]):
            self._m_spill.add()

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
        if pid != 0 and self._raise_cow:
            self._raise_cow = False
            raise ServingFaultError("injected cow fault")
        new = self._alloc_slot_page(slot, j)
        if pid != 0:
            _cow_copy(self._cache, pid, new)
            self._pool.release(pid)
            self.counters["cow_copies"] += 1
            self._m_cow.add()
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
