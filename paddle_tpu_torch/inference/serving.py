"""Continuous-batching serving engine: dense slot-pool KV cache,
power-of-two bucketed prefill, one decode tick for all slots.

Counterpart of paddle_tpu/inference/serving.py (the dense layout).
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
- **Quarantine.** With guardrails on, a row whose logits are not all
  finite folds into a -1 token on the device (real ids are never
  negative); the host finishes only that request as "poisoned".
- **Weight-only int8.** quant="int8" rewrites the params tree at build
  (quantization/serving.py); the forward picks the int8 pairs up from
  the tree and every block matmul and the head run the hand-written
  Hopper kernel (kernels/quant_matmul.py) on the card: per full pass,
  the family's quantized leaves per layer times the depth, plus the
  head (GPT 4 L + 1, Llama 7 L + 1).

Sampled streams cannot match the reference bit for bit (it draws with
threefry). The invariant is kept instead: a request's sampled stream
depends only on (seed, request id, token index), never on its slot or
on the rest of the batch. The noise is a counter-based hash of those
three values and the vocabulary index, computed on the device, and the
draw is Gumbel-max over the temperature-scaled, top-k-masked logits.

Every request resolves exactly once with a finish reason from
TERMINAL_REASONS. Engine knobs of later slices (paged KV, speculative
decode, multi-tick, host KV tier, tensor-parallel meshes, telemetry,
tracing, watchdog and retries, queue bounds) raise NotImplementedError
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.decode import prompt_bucket

__all__ = ["ServingEngine", "Request", "ModelFamily", "family_for",
           "create_serving_engine", "TERMINAL_REASONS"]

TERMINAL_REASONS = frozenset(
    {"eos", "length", "cancelled", "poisoned", "evicted"})

# knob -> (values that leave the knob inert, the ROADMAP item porting it)
_UNPORTED = {
    "kv_layout": (("auto", "dense"), "A5 (paged KV layout)"),
    "page_size": ((16,), "A5 (paged KV layout)"),
    "num_pages": ((0,), "A5 (paged KV layout)"),
    "prefill_chunk": ((0,), "A5 (paged KV layout)"),
    "prefix_sharing": ((True,), "A5 (paged KV layout)"),
    "spec_decode": (("auto", "off"), "A5 (speculative decode)"),
    "gamma": ((4,), "A5 (speculative decode)"),
    "draft_layers": ((0,), "A5 (speculative decode)"),
    "multi_tick": ((0, 1), "A5 (multi-tick decode)"),
    "host_kv_bytes": ((0,), "A5 (host KV tier)"),
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


# --------------------------------------------------------------- families
@dataclasses.dataclass(frozen=True)
class ModelFamily:
    """The seam a model family exposes to the engine: a cached forward
    that accepts per-row positions, and a cache factory."""
    name: str
    forward_cached: Callable    # (params, tokens[B,T], cache, pos, cfg)
    init_cache: Callable        # (cfg, batch, max_len, device) -> {"k","v"}


def family_for(name: str) -> ModelFamily:
    if name == "gpt":
        from ..models import gpt
        return ModelFamily("gpt", gpt.gpt_forward_cached, gpt.init_kv_cache)
    if name == "llama":
        from ..models import llama
        return ModelFamily("llama", llama.llama_forward_cached,
                           llama.init_kv_cache)
    raise ValueError(f"unknown model family {name!r} (gpt|llama)")


# --------------------------------------------------------------- requests
class Request:
    """One generation request riding through the engine."""

    __slots__ = ("id", "prompt", "max_new_tokens", "temperature", "top_k",
                 "eos_id", "tokens", "done", "finish_reason", "slot",
                 "_engine")

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
        masked = torch.where(keep, vals, torch.tensor(float("-inf"),
                                                      device=lg.device))
        choice = torch.argmax(masked / safe_t + g.gather(1, idx), dim=-1)
        trunc = idx.gather(1, choice[:, None])[:, 0]
        sampled = torch.where(top_ks > 0, trunc, sampled)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


# ---------------------------------------------------------- device bodies
# slot-state tuple riding through the decode tick (all [N] on the device)
#   (cur_tok, positions, active, temps, top_ks, req_ids, gen_idx)
@torch.no_grad()
def _decode_tick(params, cache, state, seed, *, fwd, cfg, max_top_k,
                 sampling, guard):
    """All N slots advance one token; inactive slots compute too (fixed
    shape) but their output is masked, and they write their K/V at their
    stale position, which the next prefill of that slot overwrites."""
    toks, positions, active, temps, top_ks, req_ids, gen_idx = state
    logits, cache = fwd(params, toks[:, None], cache, positions, cfg)
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
    """

    def __init__(self, params, cfg, family="gpt", num_slots: int = 8,
                 max_len: Optional[int] = None, max_top_k: int = 0,
                 seed: int = 0, bucket_lo: int = 8, guardrails: bool = True,
                 quant: str = "auto", device=None, **later_knobs):
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
        # weight-only int8: a leaf rewrite at build, before the upload,
        # so the dropped fp matmul weights never reach the card
        from ..kernels.quant_matmul import resolve_quant
        self.quant = resolve_quant(quant, self.device)
        self._quant_info = None
        if self.quant:
            from ..quantization.serving import quantize_serving_params
            params, self._quant_info = quantize_serving_params(
                params, self.family.name)
        self._params = _to_device(params, self.device)
        self._cache = self.family.init_cache(cfg, self.num_slots,
                                             self.max_len,
                                             device=self.device)
        n = self.num_slots
        # host mirrors of the slot state; the device copy is rebuilt
        # from them only when admission or a finish dirties them
        self._positions = np.zeros(n, np.int32)
        self._active = np.zeros(n, bool)
        self._cur_tok = np.zeros(n, np.int32)
        self._temps = np.zeros(n, np.float32)
        self._top_ks = np.zeros(n, np.int32)
        self._req_ids = np.zeros(n, np.int32)
        self._gen_idx = np.zeros(n, np.int32)
        self._dstate = None
        self._dirty = True
        self._slot_req: List[Optional[Request]] = [None] * n
        self._queue: collections.deque = collections.deque()
        self._next_id = 0
        self._ticks = 0
        # host-clock samples (ms) of each decode tick and each prefill,
        # each ending in the host pull that waits for the device
        self.tick_ms: collections.deque = collections.deque(maxlen=8192)
        self.prefill_ms: collections.deque = collections.deque(maxlen=8192)
        self.counters = {"prefills": 0, "decode_ticks": 0,
                         "tokens_emitted": 0, "quant_matmuls": 0}
        # fused dequant-matmuls per full forward: quantized leaves per
        # layer x depth + the head (the reference's formula)
        self._qmm_full = 0
        if self._quant_info:
            self._qmm_full = (self._quant_info["per_layer"] * cfg.num_layers
                              + self._quant_info["head"])

    # ------------------------------------------------------- observables
    def quant_stats(self) -> dict:
        if not self._quant_info:
            return {"quant": "off"}
        return {"quant": "int8", **self._quant_info}

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
        req = Request(self._next_id, prompt, int(max_new_tokens),
                      float(temperature), int(top_k), eos_id)
        req._engine = self
        self._next_id += 1
        self._queue.append(req)
        return req

    # --------------------------------------------------------- the tick
    def step(self):
        """One engine tick: admit queued requests into free slots (one
        bucketed prefill each), then advance every active slot one token
        through the decode tick. Returns this tick's (request, token)
        emissions."""
        events: List[tuple] = []
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                break
            req = self._queue.popleft()
            try:
                self._admit(slot, req, events)
            except BaseException:
                # no limbo: the request resolves before the error surfaces
                self._rollback_slot(slot, req)
                self._finish(req, "evicted")
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
        mirror; the device state is rebuilt before the next tick."""
        self._slot_req[slot] = None
        self._active[slot] = False
        self._positions[slot] = 0
        self._cur_tok[slot] = 0
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._gen_idx[slot] = 0
        self._dirty = True

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
        self._dirty = True
        req.tokens.append(tok)
        events.append((req, tok))
        self.counters["tokens_emitted"] += 1
        self._maybe_finish(req)

    def _decode(self, events: list) -> None:
        if self._dirty:
            self._dstate = (
                self._upload(self._cur_tok), self._upload(self._positions),
                self._upload(self._active), self._upload(self._temps),
                self._upload(self._top_ks), self._upload(self._req_ids),
                self._upload(self._gen_idx))
            self._dirty = False
        sampling = bool(np.any(self._temps[self._active] > 0.0))
        t_dev0 = time.perf_counter()
        nxt, self._dstate = _decode_tick(
            self._params, self._cache, self._dstate, self.seed,
            fwd=self.family.forward_cached, cfg=self.cfg,
            max_top_k=self.max_top_k, sampling=sampling,
            guard=self.guardrails)
        toks = nxt.cpu().numpy()         # ONE host pull per tick
        self.tick_ms.append((time.perf_counter() - t_dev0) * 1e3)
        self.counters["decode_ticks"] += 1
        self.counters["quant_matmuls"] += self._qmm_full
        for i in np.nonzero(self._active)[0]:
            req = self._slot_req[i]
            tok = int(toks[i])
            if tok < 0:
                # evict ONLY this slot; the device state advanced its row,
                # so _finish dirties it and co-batched rows rebuild from
                # their clean mirrors
                self._poisoned(req, "decode")
                continue
            self._emit_token(i, req, tok, events)

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
