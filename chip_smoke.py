#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit) when it fails:

1. The card's name and power limit (nvidia-smi), the torch/CUDA
   versions, and the build of every hand-written kernel from the
   sources in this checkout (one nvcc per source, all at once), with
   nvcc's -Xptxas -v register, shared-memory and spill summary; the
   D = 64 instantiations of the three bf16 attention kernels (the
   forward at both q tiles) and every bf16 instantiation of the int8
   dequant-matmul must not spill.
2. Kernel checks, each kernel against its plain PyTorch version on the
   card at the shapes of its main path, with kernel, plain and library
   times from CUDA events, the bound and the error (one JSON line per
   shape):
   - the fused int8 dequant-matmul, bf16 x, at the GPT and the Llama
     serving shapes (M = 8 slots at decode, 128 and 512 at prefill, and
     at Llama's shapes 40, the spec verify pass of 8 slots x (gamma 4 +
     1), 256, the paged prefill chunk, and 1024, the dense path's largest
     prefill bucket;
     K, N of GPT's qkv, attention-out, MLP-up, MLP-down and head matmuls
     and of Llama's q/o, k/v, gate/up, down and head), the same bits
     twice at each, then one row for each family's decode tick (GPT's 97
     calls, Llama's 155, at M = 8 summed); then the f64 bound check: at
     every leaf shape and M = 8, 16, 128 and 512 (and 40, 256 and 1024 at
     Llama's),
     on `_plan`'s plan and, where
     it splits K, unsplit too, every element of the kernel's bf16 output
     within ulp_bf16(y64) + K 2^-24 ((|x| @ |w|) scale) of the f64 value
     y64 = (x @ w) scale of the same bf16 x (the plain version's distance
     printed beside it);
   - the flash-attention forward and its dq and dk/dv backward kernels,
     bf16, causal, at the GPT train step's [8, 1024, 16, 64] (q, k, v
     strided views of one qkv tensor, as the GPT block makes them), a
     ragged S 1000 with kv_len 900, head dim 128, and the Llama train
     step's [4, 2048, 32, 64]; every kernel runs on tensor cores on
     bf16; the forward and the backward pair run twice must give the
     same bits; the forward's time is set beside SDPA's forward and the
     pair's beside SDPA's whole backward (vs_library); at the Llama
     shape, the kernels' and the plain versions' largest errors against
     an f64 attention from the same inputs, forward and backward (a
     measurement line);
   - the one-pass cross entropy, bf16, at [8192, 32768] (the GPT train
     step's logits) and [8192, 50304];
   - the two-pass cross entropy (forward saving the lse, backward from
     it), bf16, at [8192, 32000] (the Llama train step's logits) and
     [8192, 50257] (rows off a 16-byte boundary), the backward at
     g = 1/T (the mean loss) and g = 1;
   - the AdamW leaf update, f32, at each of the 11 leaf shapes of the
     TinyLlama-width tree, with torch._fused_adamw_ as the yardstick;
   - the threefry bits kernel (the serving sampler's draw, the slot
     keys' fold_ins included) at [8, 32768] and [8, 32000] (8 slots,
     the GPT and Llama vocabularies), every word equal to its plain
     int64 version, twice; each serving main path must launch it
     exactly once a sampled tick and a sampled prefill pass, and the
     phases with sampled requests (5, 5b, 5c, 5d) must each launch it.
3. GPT training at the full width of the repo's headline configuration
   (bench.py's `tpu` rung: vocab 32768, hidden 1024, 24 layers, 16
   heads, max_seq_len 1024, batch 8 x 1024 tokens, remat "dots", bf16
   activations, f32 parameters, random weights from seed 0), with the
   registry's "ce" winner forced to "pallas_fused" (the one-pass CE) as
   the reference's tools/ablate_step.py forces its own.
3b. The GPT step's selection surface at the same widths and 12 of its
   24 layers (RACE_LAYERS), the port's
   counterpart of the rung's variant race (bench.py:270-320) with the
   attention impl fixed to "pallas" (on CUDA "jax_flash" and "splash"
   run the same kernels): from one starting state, 2 warm-up and 10
   timed steps under remat "dots", "full", "dots_flash", "offload_dots"
   and "all_but_mlp" at batch 8, "all_but_mlp" at 12, no remat at 4 and
   "dots" at 16, the CE and the update on their default routes; each
   variant's step ms p50/p90, tokens/s, MFU, peak memory, pinned host
   bytes and a one-step profile, its kernel launches asserted (the flash
   forward L a step under dots_flash, all_but_mlp and no remat, 2L
   otherwise; dq and dk/dv L) and its first loss at batch 8 held to
   "dots"'s (1e-6 relative); a variant out of device memory is printed
   as OOM; then the fastest. Then one step at 4 layers under each
   route: PADDLE_TPU_ATTN_IMPL=xla and PADDLE_TPU_DISABLE_PALLAS_ATTN=1
   (no flash launch, loss within 2e-3 of the kernel step's),
   PADDLE_TPU_DISABLE_PALLAS_BWD=1 (no dq or dk/dv launch),
   PADDLE_TPU_DISABLE_PALLAS=1 (no launch at all, the CE on "jax"),
   PADDLE_TPU_ATTN_IMPL=splash and jax_flash (the kernels), each set for
   its own step, and a last default step. Then the forward's two q
   tiles (128 x 64, the default, and 64 x 64) at the GPT and Llama
   shapes: each against the plain version, against each other bit for
   bit (printed), timed; the autotune (PADDLE_TPU_AUTOTUNE=1, its cache
   in a temporary directory) times both on the first call, caches the
   pick and hits on the second; an env tile outranks the cache, a
   foreign cache entry is skipped and counted, an env tile the kernels
   lack raises.
4. Llama training at TinyLlama-1.1B's widths (vocab 32000, hidden 2048,
   22 layers, 32 heads over 4 KV heads, FFN 5632, max_seq_len 2048; the
   head tied to wte, 1,034,512,384 parameters), batch 4 x 2048 tokens,
   remat on, bf16 activations, f32 parameters, with the registry's
   "fused_update" winner forced to "pallas" (the fused AdamW kernel) and
   the cross entropy on its default two-pass route. Then a primal-only
   eval loss under torch.no_grad(), which must launch the CE forward
   alone.
   Phases 3 and 4 each run: step 1's loss and gradients on the kernels
   and on their plain versions (losses within 2e-3 relative, every
   gradient leaf's cosine >= 0.999; each leaf's cosine printed beside
   the plain-vs-plain floor, and the leaves below it named); from one
   starting state (kept on
   the host), 5 steps on each (trajectories within 1e-2); 2 warm-up and
   10 timed steps through make_train_step (step ms p50/p90, tokens/s,
   MFU, peak memory) with the exact kernel launches asserted; and 2
   steps under torch.profiler (device busy share, device time by
   kernel).
5. Serving: the int8 ServingEngine at the GPT width, 8 slots, 16
   requests (prompt lengths 16..512 from a seeded rng, 64 new tokens
   each, two of them sampled with top-k). Every request must end with
   "length", and the int8 kernel must launch exactly 97 times per
   prefill and per decode tick (24 layers x 4 leaves + the head). One
   prefill's logits and 16 greedy tokens from the kernel are held
   against the same forward built on the plain version; 16 decode ticks
   run under torch.profiler; a 2-request fp (quant="off") engine runs
   too. Both greedy streams are replayed teacher-forced through both
   versions on the decode path that made them: at every step the two
   versions' logits agree within 5% of the span; every int8 call of the
   kernel's replays (the prefill and each step, 97 a forward) lies
   within the f64 bound on its own bf16 input; and where the streams
   part, the first differing step is a one-bf16-step tie in both
   versions' logits, and the kernel leaves the plain stream nowhere
   else beyond such a tie. The f64 logits of the two tokens at the
   parting (at step 2 where the streams agree) are printed beside the
   kernel's and the plain version's.
5b. Llama serving at TinyLlama-1.1B widths (the phase 4 config, random
   weights from seed 0 drawn on the host): the int8 ServingEngine,
   family "llama", 8 slots, max_len 2048, 16 requests (prompt lengths
   16..1024 from a seeded rng, 64 new tokens each, two sampled with
   top-k), exactly 155 launches per prefill and per tick (22 layers x 7
   leaves + the head), and the checks, profile and fp engine of phase
   5, but for the one-step rule at a parting: there the 22-layer stack
   carries two faithful roundings apart by more than one bf16 step, and
   the greedy verdict rests on the f64 bound of every int8 call of both
   replays (155 a forward).
5c. Paged and speculative Llama serving at TinyLlama-1.1B widths, on
   phase 5b's host-drawn weights: the int8 engine with kv_layout
   "paged", page_size 16, prefill_chunk 256 and 513 pages (half the
   dense-equivalent 1025), 8 slots, max_len 2048, over 16 requests of
   64 new tokens (seed 7): a shared 512-token prefix and a suffix of
   16..512 tokens, request 0's suffix 256 tokens (48 full pages),
   requests 14 and 15 repeating request 0's prompt (every page mapped,
   the last one copied), requests 3 and 11 sampled with top-k. Then a
   dense engine on the same prompts, the paged engine with spec_decode
   "spec", gamma 4 and draft_layers 11, and the dense one with it. Each
   run: every request ends "length"; exactly 155 launches a prefill
   chunk (a prefill, dense) and a tick, 155 + 4 x (11 x 7 + 1) = 467 a
   spec tick; the page pool checked after every step (table references
   equal refcounts, every page free, cached or live, reservations
   conserved, no slot mapping a page past its position) and at the end
   empty of live pages and reservations; prefix hits, COW copies and
   chunks all > 0; tick ms p50/p90, prefill (chunk) ms p50/max,
   tokens/s, peak memory and pages, and the acceptance rate and tokens
   per spec tick (at random weights, which say nothing of a trained
   model's); a tick profile of the paged and the paged spec engine.
   Greedy streams are compared, paged against dense and each spec
   engine against the non-spec engine of its layout; at every
   parting both streams are replayed teacher-forced along the paths
   that made them (a verify-shaped window for spec) and phase 5b's
   verdict holds: every int8 call within the f64 bound, the two paths'
   logits and each replay's own tokens within 5% of the span.
5d. Multi-tick decode and the host KV tier at TinyLlama-1.1B widths, on
   the same weights: the engines of 5b (dense, its 16 requests) and 5c
   (paged, paged spec, dense spec, 5c's requests) at multi_tick=4, where
   a dispatch runs 4 ticks and, after each sampling flag's eager
   warm-up, is one CUDA graph replay. Each run: every request ends
   "length"; each warm-up launches exactly 4 x 155 (4 x 467 spec)
   int8 kernels, each capture records exactly as many, the replays
   launch the rest (graph_replays = dispatches - warm-ups, at most 2
   graphs); the pool checked after every step;
   every stream, greedy or sampled, equals the K = 1 engine's of its
   layout from 5b or 5c, or its parting passes 5b's verdict (a sampled
   stream's own tokens not held to the top logit); dispatch ms p50/p90,
   ms per tick, tokens/s beside the K = 1 engine's, capture ms, peak
   memory, and a profile of 4 replays (busy share, top kernels, each
   dispatch's time from CUDA events, and the int8 launches the profiler
   lists over the replays, checked at 99-100% of the engine's count:
   the profiler drops a few records late in the process). Then
   the host tier:
   8 families of a 512-token prefix and a 16..256-token suffix, 2
   requests each, 32 new tokens, served twice by the paged multi-tick
   engine with 257 pages and a 256 MiB host tier, without the tier, and
   with 1025 pages: spills and swap-ins > 0, the tier's streams equal
   the 1025-page engine's token for token and the tier-less engine's or
   each parting passes the verdict; bytes, drops, ms a swapped-in page,
   round-2 chunks and prefill p50 of each engine.
6. The planner-driven dp×fsdp×tp train step (paddle_tpu_torch/parallel,
   models/facade.py make_train_step(mesh=, plan=)) at phase 4's
   configuration, from phase 4's starting state (seed 0, drawn again).
   6a: a 1-rank NCCL group, plan dp1×fsdp1×tp1, the fused update forced:
   its 5 losses equal to phase 4's kernel trajectory (within 1e-6
   relative; whether to the bit is printed), its launches a step
   exactly phase 4's (flash 44 / 22 / 22, ce_fwd 1, ce_bwd 1,
   leaf_update 11), its p50 and peak beside phase 4's. 6b: two spawned
   ranks (one card each over NCCL where there are two or more cards;
   on one card, both on it over gloo, every collective an all-reduce
   through parallel/collective.py's route for CUDA tensors), the plans
   tp2 (dp1×fsdp1×tp2) and fsdp2 (dp1×fsdp2×tp1) at the same global
   batch: step 1's loss within 2e-3 relative of 6a's and every
   gradient leaf's cosine >= 0.999 against the unsharded step 1 from
   the same state (phase 4's tolerances), the 5-step trajectory within
   1e-2 of 6a's, each leaf's step-1 gradient norm within 1e-2 of the
   unsharded one's (a wrong loss scale or a sum where a mean belongs
   moves it by 2x; cosine and AdamW cannot see it), exactly 6a's
   launches a step on each rank, each rank's heads (tp2: 16 query and
   2 KV), its params and moments at most 51% of 6a's, its peak and
   step times (marked as taken with both ranks on one card where they
   were). The shapes each rank's flash, CE and AdamW kernels launch at
   are recorded and must be among the shapes phases 2b, 2d and 2e held
   against the plain versions (SHARDED_PLANS' local shapes are added
   to those checks). The route, backend and card count are printed; a
   failure in a rank fails the phase. In the same two-rank world, the
   pipelined step (parallel/pipeline_train.py) on the plan
   dp1×fsdp1×tp1×pp2 with 4 microbatches of [1, 2048]: 11 layers a
   stage, the 1F1B schedule, the stage handoffs on the pp group's route
   (on one card "gloo_cuda_via_all_reduce"), the vocab-parallel loss in
   stock torch; held to the same gates, with the launches and state
   bytes its plan gives (sharded_launches: flash 88 / 44 / 44 a step a
   rank, no CE kernel, the update on the stage's 11 leaves; its
   params and moments exactly the bytes of shard_shapes, half of the
   stacked leaves and the whole wte and norm_f), its schedule's bubble
   (the 1F1B timeline's busy slots) equal to (pp-1)/(m+pp-1) and
   within 1.5x of the planner's (pp-1)/m, and one more step with every
   handoff timed between two synchronizes (the schedule's gaps, the
   route's cost, and the measured share of the step spent waiting in
   handoffs).
7. The seconds each phase took, the kernels line (the eight ported
   kernels and the threefry bits kernel),
   the card line, and as the last
   line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
   1}}.

float32 matmuls run in full float32 here: TF32 is switched off for
matmul and cuDNN, so the plain versions are exact-f32 references.
"""
import contextlib
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense bf16, HBM3), used for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FULL = dict(vocab_size=32768, hidden_size=1024, num_layers=24, num_heads=16,
            max_seq_len=1024)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024          # bench.py's tpu rung
# TinyLlama-1.1B (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T
# config.json; the repo's Llama ties the head to wte)
LLAMA = dict(vocab_size=32000, hidden_size=2048, num_layers=22,
             num_heads=32, num_kv_heads=4, max_seq_len=2048,
             rope_theta=10000.0, rms_eps=1e-5)
LLAMA_BATCH, LLAMA_SEQ = 4, 2048
_D, _L, _F, _KV = 2048, 22, 5632, 4 * 64
LLAMA_LEAVES = {"wte": (32000, _D), "norm_f": (_D,), "attn_norm": (_L, _D),
                "q_w": (_L, _D, _D), "k_w": (_L, _D, _KV),
                "v_w": (_L, _D, _KV), "o_w": (_L, _D, _D),
                "ffn_norm": (_L, _D), "gate_w": (_L, _D, _F),
                "up_w": (_L, _D, _F), "down_w": (_L, _F, _D)}
ADAMW = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
# the seconds the whole script must finish in, its kernels' builds
# included
TIME_LIMIT_S = 1200
LEAF_KN = {"qkv_w": (1024, 3072), "attn_out_w": (1024, 1024),
           "mlp_up_w": (1024, 4096), "mlp_down_w": (4096, 1024),
           "head": (1024, 32768)}
# the Llama serving path's int8 leaves at TinyLlama widths; a name "a/b"
# stands for two leaves of one shape
LLAMA_LEAF_KN = {"q_w/o_w": (_D, _D), "k_w/v_w": (_D, _KV),
                 "gate_w/up_w": (_D, _F), "down_w": (_F, _D),
                 "head": (_D, 32000)}
M_VALUES = (8, 128, 512)
# rows of the f64 bound check: decode (8 slots; 16 takes the 16-row
# tile) and prefill
F64_M_VALUES = (8, 16, 128, 512)
# extra rows of both checks at the Llama leaf shapes: the paged engine's
# spec verify pass (8 slots x (gamma 4 + 1) = 40 rows), its prefill chunk
# (256) and the dense path's largest prefill bucket (prompts up to 1024
# tokens)
LLAMA_EXTRA_M = (40, 256, 1024)


def pass_calls(leaf_kn, L):
    """{leaf: int8 calls a full pass}: each block leaf once a layer, the
    head once."""
    return {leaf: 1 if leaf == "head" else L * len(leaf.split("/"))
            for leaf in leaf_kn}


def f64_oracle(torch, x, w_q, scale, weights64=None):
    """The f64 value of (x @ w_q) * scale from the same x [..., K] and
    its bound: (y64 [M, N], ulp_bf16(y64), ulp_bf16(y64) + K 2^-24
    ((|x| @ |w_q|) scale)_64). The first term is the one rounding to
    bf16; the second bounds an f32 sum of K exact products in any order,
    so an element near cancellation passes for a correct kernel, while a
    dropped or doubled split or a wrong scale is orders past it.
    `weights64`, a dict, keeps each weight's f64 copy and its absolute
    value across calls (a replay calls every weight many times)."""
    K = w_q.shape[0]
    x64, s64 = x.reshape(-1, K).double(), scale.double()
    key = (w_q.data_ptr(), tuple(w_q.shape))
    pair = None if weights64 is None else weights64.get(key)
    if pair is None:
        w64 = w_q.double()
        pair = (w64, w64.abs())
        if weights64 is not None:
            weights64[key] = pair
    y64 = (x64 @ pair[0]) * s64
    absprod = (x64.abs() @ pair[1]) * s64
    _, e = torch.frexp(y64.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(y64), e - 8)     # bf16: 8 bits
    return y64, ulp, ulp + K * 2.0 ** -24 * absprod


def f64_verdict(torch, y, oracle):
    """How far y [..., N] lies from the oracle's y64: the largest |y -
    y64| in bf16 ulps of y64 and as a share of the bound; ok when every
    element is finite and within the bound."""
    y64, ulp, bnd = oracle
    err = (y.reshape(y64.shape).double() - y64).abs()
    share = err / bnd
    return {"max_ulps": float((err / ulp).max()),
            "max_bound_share": float(share.max()),
            "ok": bool(torch.isfinite(y).all()) and bool((share <= 1).all())}


def qmm_f64_check(torch, qm, dev):
    """Phase 2, the int8 kernel against the f64 value of its own inputs
    at every leaf shape of both serving paths and M in F64_M_VALUES: on
    `_plan`'s plan and, where that splits K, on the unsplit plan too; the
    plain version beside it. Raises unless every kernel element is within
    the bound. Returns the worst shares and ulps."""
    g = torch.Generator(device=dev).manual_seed(11)
    sm = qm._sm_count(dev)
    worst = {"kernel_max_ulps": 0.0, "kernel_max_bound_share": 0.0,
             "plain_max_ulps": 0.0, "plain_max_bound_share": 0.0}
    shapes = sorted(set(LEAF_KN.values()) | set(LLAMA_LEAF_KN.values()))
    llama_shapes = sorted(set(LLAMA_LEAF_KN.values()))
    for M in F64_M_VALUES + LLAMA_EXTRA_M:
        for K, N in shapes if M in F64_M_VALUES else llama_shapes:
            x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                              dtype=torch.int8)
            s = torch.rand(N, generator=g, device=dev) * 1e-2 + 1e-4
            oracle = f64_oracle(torch, x, w, s)
            plain = f64_verdict(torch, qm.quant_matmul_ref(x, w, s), oracle)
            plans = {"plan": qm._plan(M, K, N, sm)}
            if plans["plan"].splits > 1:
                plans["unsplit"] = qm._plan(M, K, N, sm, max_splits=1)
            line = {"phase": "qmm_f64_bound", "M": M, "K": K, "N": N,
                    "plain": plain}
            for name, plan in plans.items():
                line[name] = dict(f64_verdict(torch, qm._launch(
                    x, w, s, plan=plan), oracle), splits=plan.splits)
                for k in ("max_ulps", "max_bound_share"):
                    worst["kernel_" + k] = max(worst["kernel_" + k],
                                               line[name][k])
            for k in ("max_ulps", "max_bound_share"):
                worst["plain_" + k] = max(worst["plain_" + k], plain[k])
            log(json.dumps(line))
            bad = [n for n in plans if not line[n]["ok"]]
            if bad:
                raise AssertionError(
                    f"quant_matmul outside the f64 bound at M={M} K={K} "
                    f"N={N} on the {bad} plan(s): {json.dumps(line)}")
            del x, w, s, oracle
    log(json.dumps({"phase": "qmm_f64_bound", "shapes": len(shapes),
                    "M": F64_M_VALUES, "llama_M": LLAMA_EXTRA_M, **worst,
                    "bound": "ulp_bf16(y64) + K*2^-24*((|x|@|w|)*scale)_64"}))
    return worst


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(M, K, N):
    """Least time (ms) for (x[M,K] bf16 . w[K,N] int8) * scale[N] f32 ->
    y[M,N] bf16: each input read once and the output written once over
    the HBM rate, or the 2MKN operations over the bf16 peak."""
    return bound_ms(2.0 * M * K * N, K * N + 2 * M * K + 2 * M * N + 4 * N)


_SIDE_STREAM = []


def graph_ms(torch, fn, n_iters):
    """Device time per call: capture n_iters calls into a CUDA graph,
    replay it (warm), and time one replay with CUDA events. The warm-up
    runs on one side stream kept for every call: cuBLAS keeps a
    workspace for each stream it has run on, so a new stream a call
    would leave ~32 MiB allocated each time."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    s = _SIDE_STREAM[0]
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n_iters):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n_iters)


def kernel_check(torch, qm, dev):
    """Phase 2, at the leaf shapes of both serving paths. Returns
    {(M, K, N): row}."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    shapes = list(LEAF_KN.values()) + [
        kn for kn in LLAMA_LEAF_KN.values() if kn not in LEAF_KN.values()]
    llama_shapes = list(dict.fromkeys(LLAMA_LEAF_KN.values()))
    for M in M_VALUES + LLAMA_EXTRA_M:
        for K, N in shapes if M in M_VALUES else llama_shapes:
            # cycle enough weight copies (>= 150 MB) that every call
            # finds its weight cold in the 50 MB L2, as the serving tick
            # does with its 97 different weights
            n_copies = max(2, math.ceil(150e6 / (K * N)))
            x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            ws = [torch.randint(-127, 128, (K, N), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(n_copies)]
            ss = [torch.rand(N, generator=g, device=dev) * 1e-2 + 1e-4
                  for _ in range(n_copies)]
            y = qm.quant_matmul(x, ws[0], ss[0])
            # a fixed reduction order (split-K included): the same bits
            # from a second call
            again = qm.quant_matmul(x, ws[0], ss[0])
            ref = qm.quant_matmul_ref(x, ws[0], ss[0])
            torch.cuda.synchronize()
            same_bits = torch.equal(y.view(torch.int16),
                                    again.view(torch.int16))
            if not same_bits:
                raise AssertionError(
                    f"quant_matmul gives other bits on a second call at "
                    f"M={M} K={K} N={N}")
            # tolerance: both round an f32 value to bf16 once (at most
            # one bf16 step apart, 2^-7 relative), and the two f32 sums
            # differ only by summation order over K (K * 2^-24 of the
            # sum of |products|)
            absprod = (x.float().abs() @ ws[0].float().abs()) * ss[0]
            tol = 2.0 ** -7 * ref.float().abs() + K * 2.0 ** -24 * absprod
            err = (y.float() - ref.float()).abs()
            max_err = float(err.max())
            if not bool((err <= tol).all()) or not bool(
                    torch.isfinite(y).all()):
                raise AssertionError(
                    f"quant_matmul kernel disagrees with its plain version "
                    f"at M={M} K={K} N={N}: max |err| {max_err}, worst "
                    f"err/tol {float((err / tol).max())}")
            wb = [(w.float() * s).to(torch.bfloat16) for w, s in zip(ws, ss)]
            n_it = 4 * n_copies
            kernel_ms = graph_ms(torch, lambda i: qm.quant_matmul(
                x, ws[i % n_copies], ss[i % n_copies]), n_it)
            plain_ms = graph_ms(torch, lambda i: qm.quant_matmul_ref(
                x, ws[i % n_copies], ss[i % n_copies]), n_it)
            library_ms = graph_ms(torch, lambda i: torch.matmul(
                x, wb[i % n_copies]), n_it)
            b_ms, b_by = bound(M, K, N)
            row = {"phase": "kernel_check", "kernel": "quant_matmul",
                   "M": M, "K": K, "N": N, "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library": "torch.matmul(x, w_bf16), weight dequantized "
                              "to bf16 beforehand (reads 2x the weight "
                              "bytes; a yardstick the port never calls)",
                   "bound_ms": b_ms, "bound_by": b_by,
                   "roofline_share": b_ms / kernel_ms,
                   "vs_library": kernel_ms / library_ms,
                   "max_abs_err": max_err, "same_bits_twice": same_bits,
                   "plan": qm._plan(M, K, N, qm._sm_count(dev))._asdict(),
                   "design": QMM_DESIGN,
                   "tolerance": "2^-7*|ref| + K*2^-24*(|x|@|w|)*scale"}
            log(json.dumps(row))
            rows[(M, K, N)] = row
            del ws, ss, wb
    for fam, leaf_kn, L in (("gpt", LEAF_KN, FULL["num_layers"]),
                            ("llama", LLAMA_LEAF_KN, LLAMA["num_layers"])):
        agg = tick_aggregate(rows, leaf_kn, L)
        log(json.dumps({"phase": "kernel_check", "kernel": "quant_matmul",
                        "family": fam,
                        "per": f"one {fam} decode tick at M=8: "
                               f"{pass_calls(leaf_kn, L)}, {agg['calls']} "
                               "calls",
                        **agg, "roofline_share": agg["bound_ms"]
                        / agg["kernel_ms"],
                        "vs_library": agg["kernel_ms"] / agg["library_ms"]}))
    return rows


def tick_aggregate(rows, leaf_kn, L):
    """The launches of one decode tick at M=8 (each block leaf L times,
    the head once: GPT 97, Llama 155), summed per metric; the bound from
    the summed bytes and operations."""
    calls = pass_calls(leaf_kn, L)
    agg = {"calls": sum(calls.values())}
    for key in ("kernel_ms", "plain_ms", "library_ms"):
        agg[key] = sum(calls[leaf] * rows[(8,) + kn][key]
                       for leaf, kn in leaf_kn.items())
    ops = sum(calls[leaf] * 2.0 * 8 * k * n
              for leaf, (k, n) in leaf_kn.items())
    nbytes = sum(calls[leaf] * (k * n + 2 * 8 * k + 2 * 8 * n + 4 * n)
                 for leaf, (k, n) in leaf_kn.items())
    agg["bound_ms"], agg["bound_by"] = bound_ms(ops, nbytes)
    agg["bound_bytes"] = nbytes
    return agg


def ptxas_summary(report):
    """One line per compiled kernel from nvcc's -Xptxas -v report:
    registers, shared memory and spills."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), ""
            name = name[name.find("_cu_") + 4:] if "_cu_" in name else name
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"{name[:70]}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
    return out


# the D = 64 bf16 forward at both of its q tiles (128 rows, 64 rows)
FLASH_NO_SPILL = ("flash_fwd_kernelILi64ELi2E", "flash_fwd_q64_kernelILi64E",
                  "flash_bwd_dq_kernelILi64E", "flash_bwd_dkv_kernelILi64E")
# the bf16 dequant-matmul's three tile heights (8, 16 and 64 rows)
QMM_NO_SPILL = ("qmm_mma_kernelILi1E", "qmm_mma_kernelILi2E",
                "qmm_mma_kernelILi8E")
QMM_DESIGN = ("mma.sync bf16 (y^T = w^T x^T), int8 -> bf16 by byte "
              "permute, cp.async stages, deterministic split-K at M <= 16")


def check_no_spills(report, names=FLASH_NO_SPILL):
    """Raise unless nvcc's -Xptxas -v report shows each named kernel
    (a mangled-name fragment) compiled with no spill stores or loads."""
    found = {}
    name = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((n for n in names if n in m.group(1)), None)
        elif name and "spill" in line:
            found[name] = line.strip()
            name = None
    bad = {n: found.get(n) for n in names
           if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                            found.get(n) or "")}
    if bad:
        raise AssertionError(f"ptxas reports spills (or no entry): {bad}")


def event_ms(torch, fn, n_iters=10):
    """Device time per call from CUDA events around n_iters calls, after
    2 warm-up calls (each call here runs >= tens of microseconds, so
    launch overhead is a small share)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iters


def bound_ms(ops, nbytes):
    """Least time (ms): the larger of the operations over the bf16 tensor
    peak and the bytes over the HBM rate, and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


# phase 6b's plans of the Llama step on two ranks, by plan name (the
# pipelined one with its microbatches: the planner's default, 4·pp = 8,
# does not divide the batch of 4), and the (query heads, KV heads) each
# rank holds under each
SHARDED_PLANS = {"dp1_fsdp1_tp2": {"dp": 1, "fsdp": 1, "tp": 2},
                 "dp1_fsdp2_tp1": {"dp": 1, "fsdp": 2, "tp": 1},
                 "dp1_fsdp1_tp1_pp2": {"dp": 1, "fsdp": 1, "tp": 1,
                                       "pp": 2, "microbatches": 4}}
SHARDED_HEADS = {"dp1_fsdp1_tp2": (16, 2), "dp1_fsdp2_tp1": (32, 4),
                 "dp1_fsdp1_tp1_pp2": (32, 4)}


def plan_pp(name):
    return SHARDED_PLANS[name].get("pp", 1)


def sharded_rows(name):
    """Rows of the global batch a rank of plan `name` trains on."""
    axes = SHARDED_PLANS[name]
    return LLAMA_BATCH // (axes["dp"] * axes["fsdp"])


def kernel_rows(name):
    """Rows one kernel launch of plan `name` sees: a microbatch's under
    pp, else the rank's."""
    return sharded_rows(name) // SHARDED_PLANS[name].get("microbatches", 1)


# the Llama step's attention on one rank of each plan, [B, S, H, 64]
SHARDED_ATTN = {name: (kernel_rows(name), LLAMA_SEQ, SHARDED_HEADS[name][0],
                       LLAMA["hidden_size"] // LLAMA["num_heads"], None)
                for name in SHARDED_PLANS}
# (B, S, H, D, kv_len): the GPT train step's attention, a ragged S with
# a kv_len bound, head dim 128 (the 6.7B/13B head width), the Llama
# train step's (32 query heads, the 4 KV heads repeated to match), and
# the Llama step's on one rank of each of phase 6b's plans
ATTN_SHAPES = [(8, 1024, 16, 64, None), (8, 1000, 16, 64, 900),
               (8, 1024, 8, 128, None), (4, 2048, 32, 64, None)] + [
    sh for sh in SHARDED_ATTN.values()]
ATTN_MAIN = ATTN_SHAPES[0]
ATTN_LLAMA = ATTN_SHAPES[3]
# how each attention kernel computes its products on bf16 operands
ATTN_DESIGN = {"flash_fwd": "mma.sync bf16",
               "flash_bwd_dq": "mma.sync bf16",
               "flash_bwd_dkv": "mma.sync bf16"}


def live_pairs(S, kv_len):
    """(q, k) pairs a causal attention over S rows with keys below
    kv_len computes: the work this run's data needs."""
    kl = S if kv_len is None else kv_len
    return sum(min(q + 1, kl) for q in range(S))


def flash_tol(ref):
    """Elementwise tolerance of a bf16 flash kernel's output against its
    plain version, [B, S, H, D]: 2^-6 of the entry and 2^-6 of its row's
    rms over D (2 to 4 bf16 steps: each side rounds its result once, and
    p and ds once before their products, at places that differ by the
    softmax scale: the kernel scales dq and dk at the end, the plain
    version scales ds first), plus 2^-10 of the tensor's rms for rows
    that are zero but for f32 rounding noise (dq of the first causal
    row). Rows differ in scale by 10x and more (a causal row attends to
    1 to S keys), so the rms is taken per row; an error of an entry's
    typical size fails."""
    r = ref.float()
    row = r.square().mean(-1, keepdim=True).sqrt()
    return (2.0 ** -6 * (r.abs() + row)
            + 2.0 ** -10 * r.square().mean().sqrt()).clamp_min(1e-30)


def attention_check(torch, dev):
    """Phase 2b. Returns {(B, S, H, D, kv_len): {kernel: row}}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    ops = torch.ops.paddle_tpu_torch
    out_rows = {}
    for B, S, H, D, kv_len in ATTN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(S + D)
        qkv = torch.randn(B, S, 3, H, D, generator=g,
                          device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)                 # strided views
        do = torch.randn(B, S, H, D, generator=g,
                         device=dev).to(torch.bfloat16)
        klen = S if kv_len is None else kv_len
        out, lse = fa.mha_fwd(q, k, v, causal=True, kv_len=kv_len)
        grads = fa.mha_bwd(q, k, v, out, lse, do, causal=True,
                           kv_len=kv_len)
        r_out, r_lse = fa.mha_fwd_ref(q, k, v, True, kv_len)
        r_grads = fa.mha_bwd_ref(q, k, v, out, lse, do, True, kv_len)
        torch.cuda.synchronize()
        errs, over = {}, {}
        for name, got, ref in (("out", out, r_out), ("dq", grads[0],
                                                      r_grads[0]),
                               ("dk", grads[1], r_grads[1]),
                               ("dv", grads[2], r_grads[2])):
            err = (got.float() - ref.float()).abs()
            errs[name] = float(err.max())
            over[name] = float((err / flash_tol(ref)).max())
            if not bool(torch.isfinite(got).all()):
                over[name] = math.inf
        lse_err = float((lse - r_lse).abs().max())
        # the backward pair is two passes without atomics: a second run
        # on the same inputs gives the same bits
        again = fa.mha_bwd(q, k, v, out, lse, do, causal=True,
                           kv_len=kv_len)
        same_bits = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                        for a, b in zip(grads, again))
        out2, lse2 = fa.mha_fwd(q, k, v, causal=True, kv_len=kv_len)
        fwd_same_bits = torch.equal(out.view(torch.int16),
                                    out2.view(torch.int16)) and \
            torch.equal(lse, lse2)
        del again, out2, lse2
        log(json.dumps({"phase": "flash_err_over_tol",
                        "shape": [B, S, H, D, kv_len], **over,
                        "lse_max_abs_err": lse_err,
                        "fwd_same_bits_twice": fwd_same_bits,
                        "bwd_same_bits_twice": same_bits}))
        if max(over.values()) > 1.0 or lse_err > 1e-3:
            raise AssertionError(
                f"flash kernels disagree with their plain versions at "
                f"{(B, S, H, D, kv_len)}: worst |err| / tolerance {over}, "
                f"lse max |err| {lse_err} (tolerance 1e-3)")
        if not (same_bits and fwd_same_bits):
            raise AssertionError(
                f"flash kernels differ between two runs on the same "
                f"inputs at {(B, S, H, D, kv_len)}: forward same bits "
                f"{fwd_same_bits}, backward {same_bits}")

        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        tile = fa.flash_block_candidates(D, q.dtype)[0]    # the default
        t_fwd = event_ms(torch, lambda: ops.flash_fwd(q, k, v, True, klen,
                                                      *tile))
        t_dq = event_ms(torch, lambda: ops.flash_bwd_dq(
            q, k, v, do, lse, delta, True, klen, *fa.BWD_BLOCKS[0]))
        t_dkv = event_ms(torch, lambda: ops.flash_bwd_dkv(
            q, k, v, do, lse, delta, True, klen, *fa.BWD_BLOCKS[0]))
        p_fwd = event_ms(torch, lambda: fa.mha_fwd_ref(q, k, v, True,
                                                       kv_len), 3)
        p_bwd = event_ms(torch, lambda: fa.mha_bwd_ref(
            q, k, v, out, lse, do, True, kv_len), 3)
        # library yardstick: SDPA on [B, H, S, D] views, causal (with the
        # kv_len bound as an explicit boolean mask where there is one)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        qT, kT, vT = (t.transpose(1, 2) for t in (lq, lk, lv))
        if kv_len is None:
            def sdpa():
                return F.scaled_dot_product_attention(qT, kT, vT,
                                                      is_causal=True)
        else:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < kv_len)

            def sdpa():
                return F.scaled_dot_product_attention(qT, kT, vT,
                                                      attn_mask=mask)
        with torch.no_grad():
            l_fwd = event_ms(torch, sdpa)
        lo = sdpa()
        doT = do.transpose(1, 2)
        l_bwd = event_ms(torch, lambda: torch.autograd.grad(
            lo, (lq, lk, lv), doT, retain_graph=True))
        del lo

        pairs = B * H * live_pairs(S, kv_len)
        e = 2                                   # bf16 bytes
        q_bytes = B * S * H * D * e
        kv_bytes = B * min(S, klen) * H * D * e
        row_bytes = B * H * S * 4               # lse or delta, f32
        b_fwd = bound_ms(4 * pairs * D, q_bytes + 2 * kv_bytes + q_bytes
                         + row_bytes)
        b_dq = bound_ms(6 * pairs * D, 2 * q_bytes + 2 * kv_bytes
                        + 2 * row_bytes + q_bytes)
        b_dkv = bound_ms(8 * pairs * D, 2 * q_bytes + 2 * kv_bytes
                         + 2 * row_bytes + 2 * B * S * H * D * e)
        shape = {"B": B, "S": S, "H": H, "D": D, "kv_len": kv_len,
                 "causal": True, "dtype": "bfloat16"}
        rows = {
            "flash_fwd": dict(ms=t_fwd, plain_ms=p_fwd, library_ms=l_fwd,
                              bound=b_fwd, max_abs_err=errs["out"],
                              err_over_tol=over["out"],
                              lse_max_abs_err=lse_err,
                              design=ATTN_DESIGN["flash_fwd"]),
            "flash_bwd_dq": dict(ms=t_dq, plain_ms=p_bwd, library_ms=None,
                                 bound=b_dq, max_abs_err=errs["dq"],
                                 err_over_tol=over["dq"],
                                 design=ATTN_DESIGN["flash_bwd_dq"]),
            "flash_bwd_dkv": dict(ms=t_dkv, plain_ms=p_bwd,
                                  library_ms=None, bound=b_dkv,
                                  max_abs_err=max(errs["dk"],
                                                  errs["dv"]),
                                  err_over_tol=max(over["dk"],
                                                   over["dv"]),
                                  design=ATTN_DESIGN["flash_bwd_dkv"]),
        }
        for name, r in rows.items():
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            line = {"phase": "kernel_check", "kernel": name, **shape, **r,
                    "roofline_share": r["bound_ms"] / r["ms"],
                    "tolerance": "per entry 2^-6*(|ref| + rms of its row "
                                 "over D) + 2^-10*rms(ref); lse 1e-3"}
            if name != "flash_fwd":
                line["plain_note"] = ("mha_bwd_ref computes dq, dk and dv "
                                      "together")
                line["library_bwd_pair_ms"] = l_bwd
                line["pair_ms"] = t_dq + t_dkv
                line["vs_library"] = (t_dq + t_dkv) / l_bwd
                line["bwd_same_bits_twice"] = same_bits
                line["library_note"] = (
                    "no library call computes this pass alone; "
                    "library_bwd_pair_ms is SDPA's whole backward "
                    "(dq, dk, dv), against the sum of the two kernels")
            else:
                line["library"] = "F.scaled_dot_product_attention forward"
                line["vs_library"] = t_fwd / l_fwd
                line["fwd_same_bits_twice"] = fwd_same_bits
            log(json.dumps(line))
        out_rows[(B, S, H, D, kv_len)] = rows
        del qkv, q, k, v, do, out, lse, grads, r_out, r_lse, r_grads
        del lq, lk, lv, qT, kT, vT, delta
    return out_rows


def attention_f64(torch, q, k, v, do):
    """Causal attention and its gradients in f64 from the same bf16
    inputs [B, S, H, D], one batch row at a time: (out, lse [B, H, S],
    dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    outs = []
    for b in range(q.shape[0]):
        qb, kb, vb, dob = (t[b].double().transpose(0, 1)
                           for t in (q, k, v, do))            # [H, S, D]
        S = qb.shape[1]
        s = (qb @ kb.transpose(-1, -2)) * scale
        s.masked_fill_(~q.new_ones(S, S, dtype=bool).tril(), -math.inf)
        lse = s.logsumexp(-1)
        p = (s - lse[..., None]).exp_()
        del s
        o = p @ vb
        ds = dob @ vb.transpose(-1, -2)
        ds.sub_((dob * o).sum(-1, keepdim=True)).mul_(p)
        outs.append((o, lse, ds @ kb * scale,
                     ds.transpose(-1, -2) @ qb * scale,
                     p.transpose(-1, -2) @ dob))
        del p, ds
    o, lse, dq, dk, dv = (torch.stack(t) for t in zip(*outs))
    return (o.transpose(1, 2), lse, dq.transpose(1, 2), dk.transpose(1, 2),
            dv.transpose(1, 2))


def attention_oracle(torch, dev):
    """Phase 2b's Llama shape against an f64 attention (ROADMAP C2): the
    largest and the rms |err| of the kernels and of the plain bf16
    versions, each from its own forward, against f64 from the same bf16
    inputs, forward and backward. A measurement line; the checks stay
    phase 2b's."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    B, S, H, D, _ = ATTN_LLAMA
    g = torch.Generator(device=dev).manual_seed(S + D)
    qkv = torch.randn(B, S, 3, H, D, generator=g,
                      device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    ref = attention_f64(torch, q, k, v, do)
    out, lse = fa.mha_fwd(q, k, v, causal=True)
    kern = (out, lse) + tuple(fa.mha_bwd(q, k, v, out, lse, do, causal=True))
    r_out, r_lse = fa.mha_fwd_ref(q, k, v, True, None)
    plain = (r_out, r_lse) + tuple(fa.mha_bwd_ref(q, k, v, r_out, r_lse, do,
                                                  True, None))
    line = {"phase": "flash_f64_oracle", "shape": [B, S, H, D],
            "causal": True, "dtype": "bfloat16"}
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        line[name] = {"f64_rms": float(ref[i].square().mean().sqrt())}
        for who, got in (("kernel", kern[i]), ("plain", plain[i])):
            err = got.double() - ref[i]
            line[name][who + "_max_abs_err"] = float(err.abs().max())
            line[name][who + "_rms_err"] = float(err.square().mean().sqrt())
    log(json.dumps(line))
    del qkv, q, k, v, do, ref, out, lse, kern, r_out, r_lse, plain
    torch.cuda.empty_cache()
    return line


CE_SHAPES = [(8192, 32768), (8192, 50304)]
# the Llama step's logits, GPT-2's vocabulary, and the Llama step's
# logits on one rank of each of phase 6b's 3D plans (tp2's are the whole
# batch's; the pipelined step's vocab-parallel loss is stock torch and
# launches no CE kernel)
SHARDED_CE = {name: (sharded_rows(name) * LLAMA_SEQ, LLAMA["vocab_size"])
              for name in SHARDED_PLANS if plan_pp(name) == 1}
CE_PAIR_SHAPES = [(8192, 32000), (8192, 50257)] + sorted(
    set(SHARDED_CE.values()) - {(8192, 32000)})


def ce_check(torch, dev):
    """Phase 2c, the one-pass CE. Returns {(T, V): row}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import fused_ce as fce
    rows = {}
    for T, V in CE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(V)
        x = (torch.randn(T, V, generator=g, device=dev) * 2).to(
            torch.bfloat16)
        t = torch.randint(0, V, (T,), generator=g, device=dev)
        loss, dx = fce.ce_fused(x, t)
        r_loss, r_dx = fce.ce_fused_ref(x, t)
        torch.cuda.synchronize()
        # tolerance: f32 sums of exps in another order (loss), and dx
        # rounded once to bf16 from f32 values ~1e-6 apart: one step
        # (the unit cotangent: every |dx| entry is up to 1)
        loss_err = float((loss - r_loss).abs().max())
        err = (dx.float() - r_dx.float()).abs()
        dx_err = float(err.max())
        if loss_err > 1e-3 or not bool(
                (err <= 2.0 ** -7 * r_dx.float().abs() + 1e-6).all()):
            raise AssertionError(
                f"fused_ce kernel disagrees with its plain version at "
                f"T={T} V={V}: loss |err| {loss_err}, dx |err| {dx_err}")
        del r_loss, r_dx, err
        t_k = event_ms(torch, lambda: fce.ce_fused(x, t))
        t_p = event_ms(torch, lambda: fce.ce_fused_ref(x, t), 3)
        xl = x.detach().requires_grad_()
        t_l = event_ms(torch, lambda: torch.autograd.grad(
            F.cross_entropy(xl, t, reduction="sum"), xl))
        b_ms, b_by = bound_ms(0, 2 * T * V * 2 + T * 8 + T * 4)
        row = {"phase": "kernel_check", "kernel": "fused_ce", "T": T,
               "V": V, "dtype": "bfloat16", "ms": t_k, "plain_ms": t_p,
               "library_ms": t_l,
               "library": "F.cross_entropy forward + backward (bf16 "
                          "logits; a yardstick the port never calls)",
               "bound_ms": b_ms, "bound_by": b_by,
               "roofline_share": b_ms / t_k, "max_abs_err": max(loss_err,
                                                                dx_err),
               "loss_max_abs_err": loss_err, "dx_max_abs_err": dx_err,
               "tolerance": "loss 1e-3; dx 2^-7*|ref| + 1e-6"}
        log(json.dumps(row))
        rows[(T, V)] = row
        del x, t, loss, dx, xl
    return rows


def ce_pair_check(torch, dev):
    """Phase 2d, the two-pass CE. Returns {(T, V): {"ce_fwd": row,
    "ce_bwd": row}}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import fused_ce as fce
    out = {}
    for T, V in CE_PAIR_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(V)
        x = (torch.randn(T, V, generator=gen, device=dev) * 2).to(
            torch.bfloat16)
        t = torch.randint(0, V, (T,), generator=gen, device=dev)
        loss, lse = fce.ce_fwd(x, t)
        r_loss, r_lse = fce.ce_fwd_ref(x, t)
        torch.cuda.synchronize()
        # f32 sums of exps in another order
        loss_err = float((loss - r_loss).abs().max())
        lse_err = float((lse - r_lse).abs().max())
        if not loss_err <= 1e-3 or not lse_err <= 1e-3:
            raise AssertionError(
                f"ce_fwd kernel disagrees with its plain version at T={T} "
                f"V={V}: loss |err| {loss_err}, lse |err| {lse_err}")
        # both backward versions read the kernel's lse: the check is of
        # kernel 6 alone. dx within one bf16 step of the entry plus 1e-6
        # of the row's |g| (exps in another order): the bound scales
        # with g, so it means as much at g = 1/T (every entry ~1e-9) as
        # at g = 1
        dx_err, dx_over = {}, {}
        for label, gval in (("mean", 1.0 / T), ("one", 1.0)):
            g = torch.full((T,), gval, device=dev)
            dx = fce.ce_bwd(x, t, lse, g)
            r_dx = fce.ce_bwd_ref(x, t, lse, g)
            torch.cuda.synchronize()
            err = (dx.float() - r_dx.float()).abs()
            tol = 2.0 ** -7 * r_dx.float().abs() + 1e-6 * gval
            dx_err[label] = float(err.max())
            dx_over[label] = float((err / tol).max())
            if not dx_over[label] <= 1.0 or not bool(
                    torch.isfinite(dx).all()):
                raise AssertionError(
                    f"ce_bwd kernel disagrees with its plain version at "
                    f"T={T} V={V} g={gval}: max |err| {dx_err[label]}, "
                    f"worst err/tol {dx_over[label]}")
            del dx, r_dx, err, tol
        g = torch.full((T,), 1.0 / T, device=dev)
        t_fwd = event_ms(torch, lambda: fce.ce_fwd(x, t))
        t_bwd = event_ms(torch, lambda: fce.ce_bwd(x, t, lse, g))
        p_fwd = event_ms(torch, lambda: fce.ce_fwd_ref(x, t), 3)
        p_bwd = event_ms(torch, lambda: fce.ce_bwd_ref(x, t, lse, g), 3)
        with torch.no_grad():
            l_fwd = event_ms(torch, lambda: F.cross_entropy(
                x, t, reduction="none"))
        xl = x.detach().requires_grad_()
        lo = F.cross_entropy(xl, t, reduction="none")
        l_bwd = event_ms(torch, lambda: torch.autograd.grad(
            lo, xl, g, retain_graph=True))
        del lo, xl
        rows_b = T * 8 + 2 * T * 4          # targets in; loss+lse or lse+g
        shape = {"T": T, "V": V, "dtype": "bfloat16"}
        rows = {
            "ce_fwd": dict(ms=t_fwd, plain_ms=p_fwd, library_ms=l_fwd,
                           bound=bound_ms(0, T * V * 2 + rows_b),
                           max_abs_err=max(loss_err, lse_err),
                           loss_max_abs_err=loss_err,
                           lse_max_abs_err=lse_err,
                           library="F.cross_entropy(reduction='none') "
                                   "forward",
                           tolerance="loss and lse 1e-3"),
            "ce_bwd": dict(ms=t_bwd, plain_ms=p_bwd, library_ms=l_bwd,
                           bound=bound_ms(0, 2 * T * V * 2 + rows_b),
                           max_abs_err=max(dx_err.values()),
                           dx_max_abs_err=dx_err, dx_err_over_tol=dx_over,
                           library="backward of F.cross_entropy("
                                   "reduction='none') at g = 1/T, the "
                                   "forward outside the timed window",
                           tolerance="dx 2^-7*|ref| + 1e-6*|g|, at "
                                     "g = 1/T and g = 1"),
        }
        for name, r in rows.items():
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            log(json.dumps({"phase": "kernel_check", "kernel": name,
                            **shape, **r,
                            "roofline_share": r["bound_ms"] / r["ms"]}))
        out[(T, V)] = rows
        del x, t, loss, lse, r_loss, r_lse, g
    return out


def shard_shapes(name):
    """{leaf: the shape of a rank's shard} of the TinyLlama-width tree
    under phase 6b's plan `name`: each dim divided by the sizes of the
    mesh axes models/llama.py's PARAM_SPECS names for it, where they
    divide it (parallel/mesh.py's rule). 6b holds every rank's shards
    to it."""
    from paddle_tpu_torch.models.llama import PARAM_SPECS
    axes = SHARDED_PLANS[name]
    sizes = {"dp": axes["dp"], "fsdp": axes["fsdp"], "mp": axes["tp"],
             "pp": plan_pp(name)}
    out = {}
    for leaf, shape in LLAMA_LEAVES.items():
        local = list(shape)
        for d, entry in enumerate(PARAM_SPECS[leaf]):
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(sizes.get(a, 1) for a in names if a)
            if local[d] % n == 0:
                local[d] //= n
        out[leaf] = tuple(local)
    return out


def sharded_launches(name, per_step_6a):
    """{kernel: launches a step a rank} under phase 6b's plan `name`:
    6a's for a 3D plan (every rank runs every layer on its rows). Under
    pp a rank runs its stage's L/pp layers on each of its m
    microbatches, the flash forward twice (full remat recomputes it),
    the backward pair once; no CE kernel (the vocab-parallel loss is
    stock torch); the update on each of its leaves (every stage holds
    wte, norm_f and its chunk of each stacked leaf)."""
    if plan_pp(name) == 1:
        return dict(per_step_6a)
    calls = LLAMA["num_layers"] // plan_pp(name) * \
        SHARDED_PLANS[name]["microbatches"]
    out = {k: 0 for k in per_step_6a}
    out.update(flash_fwd=2 * calls, flash_bwd_dq=calls, flash_bwd_dkv=calls,
               leaf_update=len(shard_shapes(name)))
    return out


def shard_state_bytes(name):
    """Bytes of a rank's params and both AdamW moments under plan
    `name`: three f32 copies of its shards (shard_shapes)."""
    return 3 * 4 * sum(math.prod(s) for s in shard_shapes(name).values())


def update_rows(torch, dev, shapes, hp, step, tag=""):
    """The AdamW leaf update against its plain version at each of
    `shapes` ({leaf: shape}, f32), each timed beside its plain version
    and torch._fused_adamw_. Returns {leaf: row} and a "step" row, the
    sums over the leaves (one train step's update), whose library time
    is one torch._fused_adamw_ call over all of them."""
    from paddle_tpu_torch.kernels import fused_update as fu
    gen = torch.Generator(device=dev).manual_seed(7)
    leaves, rows = {}, {}
    for name, shape in shapes.items():
        p = torch.randn(shape, generator=gen, device=dev) * 0.02
        g = torch.randn(shape, generator=gen, device=dev) * 1e-3
        m = torch.randn(shape, generator=gen, device=dev) * 1e-4
        v = torch.rand(shape, generator=gen, device=dev) * 1e-7
        ref = fu.leaf_update_ref(p, g, m, v, hp)
        fu.leaf_update(p, g, m, v, hp)
        torch.cuda.synchronize()
        # both round every operation on its own in one order, and the
        # card divides and takes square roots correctly rounded: 0 ulps
        # expected, 1 ulp allowed
        errs = [float((got - want).abs().max())
                for got, want in zip((p, m, v), ref)]
        ok = all(bool(((got - want).abs()
                       <= 2.0 ** -23 * want.abs()).all())
                 for got, want in zip((p, m, v), ref))
        if not ok:
            raise AssertionError(f"leaf_update kernel disagrees with its "
                                 f"plain version at {tag}{name} {shape}: "
                                 f"max |err| p/m/v {errs}")
        del ref
        n = p.numel()
        t_k = event_ms(torch, lambda: fu.leaf_update(p, g, m, v, hp))
        t_p = event_ms(torch, lambda: fu.leaf_update_ref(p, g, m, v, hp), 3)
        t_l = event_ms(torch, lambda: torch._fused_adamw_(
            [p], [g], [m], [v], [], [step], lr=ADAMW["lr"],
            beta1=ADAMW["beta1"], beta2=ADAMW["beta2"],
            weight_decay=ADAMW["weight_decay"], eps=ADAMW["eps"],
            amsgrad=False, maximize=False))
        b_ms, b_by = bound_ms(10 * n, 28 * n)
        rows[name] = {"phase": "kernel_check", "kernel": "leaf_update",
                      "leaf": tag + name, "shape": list(shape), "n": n,
                      "dtype": "float32", "ms": t_k, "plain_ms": t_p,
                      "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
                      "roofline_share": b_ms / t_k,
                      "max_abs_err": max(errs),
                      "p_m_v_max_abs_err": errs,
                      "tolerance": "p, m, v within 1 f32 ulp (0 expected)"}
        log(json.dumps(rows[name]))
        leaves[name] = (p, g, m, v)
    n_all = sum(p.numel() for p, _, _, _ in leaves.values())
    lists = list(zip(*leaves.values()))
    t_lib = event_ms(torch, lambda: torch._fused_adamw_(
        list(lists[0]), list(lists[1]), list(lists[2]), list(lists[3]), [],
        [step] * len(leaves), lr=ADAMW["lr"], beta1=ADAMW["beta1"],
        beta2=ADAMW["beta2"], weight_decay=ADAMW["weight_decay"],
        eps=ADAMW["eps"], amsgrad=False, maximize=False))
    b_ms, b_by = bound_ms(10 * n_all, 28 * n_all)
    rows["step"] = {
        "phase": "kernel_check", "kernel": "leaf_update",
        "leaf": f"{tag}all {len(leaves)}", "n": n_all,
        "ms": sum(r["ms"] for r in rows.values()),
        "plain_ms": sum(r["plain_ms"] for r in rows.values()),
        "library_ms": t_lib,
        "library": f"one torch._fused_adamw_ call over the {len(leaves)} "
                   "leaves (the function behind "
                   "torch.optim.AdamW(fused=True))",
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values())}
    rows["step"]["roofline_share"] = b_ms / rows["step"]["ms"]
    log(json.dumps(rows["step"]))
    del leaves, lists
    torch.cuda.empty_cache()
    return rows


def update_check(torch, dev):
    """Phase 2e, the AdamW leaf update, f32, at every leaf shape of the
    TinyLlama-width tree, and at every shard shape of it under phase
    6b's plans. Returns {leaf: row}, a "step" row (one train step's
    update) and {"sharded": {plan: its step row}}."""
    step = torch.full((), 3.0, device=dev)
    hp = torch.stack([torch.full((), ADAMW[k], device=dev) for k in
                      ("lr", "beta1", "beta2", "eps", "weight_decay")]
                     + [1.0 - ADAMW["beta1"] ** step,
                        1.0 - ADAMW["beta2"] ** step])
    rows = update_rows(torch, dev, LLAMA_LEAVES, hp, step)
    rows["sharded"] = {
        name: update_rows(torch, dev, shard_shapes(name), hp, step,
                          tag=f"{name}:")["step"]
        for name in SHARDED_PLANS}
    return rows


# the serving phases with sampled requests, each of which must launch the
# threefry kernel
SAMPLING_PHASES = ("gpt_serving", "llama_serving", "llama_paged",
                   "llama_multi_tick")
# the serving sampler's draws: [slots, V] at the GPT and the Llama vocab
THREEFRY_SHAPES = [(8, FULL["vocab_size"]), (8, LLAMA["vocab_size"])]
# 32-bit integer operations a second: the data sheet's f32 rate (67
# TFLOP/s: an FMA as 2 on 128 lanes an SM) over 2 for one operation an
# instruction and over 2 for the 64 integer lanes an SM
PEAK_INT32_OPS = 67e12 / 4
# 32-bit integer operations of one Threefry-2x32 hash, counting each as
# one sm_90 instruction: the key parity k1 ^ k2 ^ 0x1BD11BDA (one
# three-input LOP3), the two counter adds, 20 rounds of add, rotate (one
# funnel shift, SHF.L.W) and xor, 10 key injections (the second word's
# a three-input IADD3 with the group's count) and the output xor
THREEFRY_HASH_OPS = 1 + 2 + 20 * 3 + 10 + 1
# a draw: per element a hash under the row's key, its parity taken once
# a row; per row the two fold_ins that make the slot's key
THREEFRY_OPS_ELEMENT = THREEFRY_HASH_OPS - 1
THREEFRY_OPS_ROW = 2 * THREEFRY_HASH_OPS + 1
THREEFRY_DESIGN = ("a row a block row; each thread folds its row's key in "
                   "once, then hashes 8 columns, the 20 rounds unrolled on "
                   "32-bit words")


def threefry_check(torch, dev):
    """Phase 2f, the threefry bits kernel (kernels/threefry.py) against
    its plain int64 version at the sampler's draws (THREEFRY_SHAPES) as
    `_sample` makes them: the engine's seed 0 and each slot's (request
    id, token index) folded in by the draw, the same bits twice; the
    same draw under the slot keys given whole (`_slot_keys`, the form
    with no fold) equal too. Timed beside the plain version. No PyTorch
    call computes these bits (torch's generators are Philox). Returns
    {(rows, n): row}."""
    from paddle_tpu_torch.inference import prng
    from paddle_tpu_torch.inference import serving as srv
    from paddle_tpu_torch.kernels import threefry as tf
    out = {}
    for rows, n in THREEFRY_SHAPES:
        rid = torch.arange(rows, dtype=torch.int32, device=dev) * 3 + 1
        gi = torch.arange(rows, dtype=torch.int32, device=dev) + 7
        s1, s2 = prng.prng_key(0)
        k1, k2 = srv._slot_keys(0, rid, gi)
        got = tf.bits(s1, s2, n, (rid, gi))
        again = tf.bits(s1, s2, n, (rid, gi))
        whole = tf.bits(k1, k2, n)
        want = tf.bits_ref(s1, s2, n, (rid, gi))
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)
                and torch.equal(whole, want)):
            bad = int((got != want).sum()) + int((whole != want).sum())
            raise AssertionError(f"threefry bits kernel disagrees with its "
                                 f"plain version at [{rows}, {n}]: {bad} "
                                 "words differ")
        t_k = event_ms(torch, lambda: tf.bits(s1, s2, n, (rid, gi)))
        t_p = event_ms(torch, lambda: tf.bits_ref(s1, s2, n, (rid, gi)), 3)
        ops = THREEFRY_OPS_ELEMENT * rows * n + THREEFRY_OPS_ROW * rows
        nbytes = 8 * rows * n + 8 * rows
        t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
        b_ms = max(t_ops, t_bytes) * 1e3
        row = {"phase": "kernel_check", "kernel": "threefry_bits",
               "shape": [rows, n], "ms": t_k, "plain_ms": t_p,
               "library_ms": None, "bound_ms": b_ms,
               "bound_by": "operations" if t_ops > t_bytes else "bytes",
               "roofline_share": b_ms / t_k, "max_abs_err": 0.0,
               "same_bits_twice": True, "design": THREEFRY_DESIGN,
               "tolerance": "every word equal"}
        log(json.dumps(row))
        out[(rows, n)] = row
        del got, again, whole, want
    return out


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else (1.0 if float(
        (a - b).abs().max()) == 0 else 0.0)


@contextlib.contextmanager
def forced_registry(**table):
    """Force the port registry's answers for the named kernels, through
    the `registry.winner` seam every consult site reads, as the
    reference's tools/ablate_step.py forces its own; restored after."""
    from paddle_tpu_torch.kernels import registry
    orig = registry.winner

    def winner(kernel, backend=None, bucket="*", path=None):
        return table.get(kernel) or orig(kernel, backend=backend,
                                         bucket=bucket, path=path)
    registry.winner = winner
    try:
        yield
    finally:
        registry.winner = orig


@contextlib.contextmanager
def plain_versions():
    """The train steps on the kernels' plain versions: rebinds the
    attention and loss that models/gpt.py and models/llama.py look up at
    each call to partials over mha_fwd_ref / mha_bwd_ref and ce_fwd_ref /
    ce_bwd_ref / ce_fused_ref, and forces the plain per-leaf AdamW;
    restores them after."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.models import gpt, llama
    saved = [(mod, mod.flash_attention_fn, mod.fused_softmax_ce)
             for mod in (gpt, llama)]
    for mod, attn, ce in saved:
        mod.flash_attention_fn = functools.partial(
            attn, fwd=fa.mha_fwd_ref, bwd=fa.mha_bwd_ref)
        mod.fused_softmax_ce = functools.partial(
            ce, fwd=fce.ce_fwd_ref, bwd=fce.ce_bwd_ref,
            fused=fce.ce_fused_ref)
    try:
        with forced_registry(fused_update="jax"):
            yield
    finally:
        for mod, attn, ce in saved:
            mod.flash_attention_fn, mod.fused_softmax_ce = attn, ce


@contextlib.contextmanager
def plain_attention_block(block):
    """The plain attention with kv blocks of `block`: the same function,
    summed in another order."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    saved, fa._BLOCK_KV = fa._BLOCK_KV, block
    try:
        yield
    finally:
        fa._BLOCK_KV = saved


def train_profile(torch, step, params, opt, tokens, card, label,
                  n_steps=2):
    """Where a train step's time goes: n_steps under torch.profiler.
    Prints the device busy share of the window and the device time by
    kernel name (top 12)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(params, opt, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(json.dumps({
        "phase": f"{label}_profile", "card": card, "steps": n_steps,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_busy_share": busy_ms / wall_ms if rows else "not measured",
        "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                         "calls": n} for us, n, k in rows[:12]]}))


def launch_counts():
    """Every kernel counter of the train steps, by kernel name."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.kernels import fused_update as fu
    return dict(fa.launches, **fce.launches, **fu.launches)


@contextlib.contextmanager
def kernel_shapes():
    """The shapes the flash and CE kernels launch at inside the body:
    {kernel: sorted [shape]}, flash (B, S, H, D), CE (T, V), taken
    where each launch is made and counted."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    seen = {}
    call, launch = fa._call, fce._launch

    def flash_call(kernel, dtype, ptrs, dims, *args, **kw):
        B, H, Sq, _, D = dims[:5]
        seen.setdefault(kernel, set()).add((B, Sq, H, D))
        return call(kernel, dtype, ptrs, dims, *args, **kw)

    def ce_launch(kernel, dtype, args, T, V, device):
        seen.setdefault(kernel, set()).add((T, V))
        return launch(kernel, dtype, args, T, V, device)
    out = {}
    fa._call, fce._launch = flash_call, ce_launch
    try:
        yield out
    finally:
        fa._call, fce._launch = call, launch
        out.update({k: sorted(list(sh) for sh in v) for k, v in seen.items()})


def zero_launch_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.kernels import fused_update as fu
    for counts in (fa.launches, fce.launches, fu.launches):
        for name in counts:
            counts[name] = 0


def train_tokens(torch, dev, cfg, batch, seq, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq + 1)), device=dev)


def host_state(params, opt):
    """A copy of (params, opt) on the host, so it takes no device memory,
    and the function that copies it back in place."""
    def host(t):
        return t.to("cpu", copy=True)
    state0 = ({k: host(v) for k, v in params.items()},
              {k: ({n: host(t) for n, t in v.items()}
                   if isinstance(v, dict) else host(v))
               for k, v in opt.items()})

    def restore():
        for k, v in state0[0].items():
            params[k].copy_(v)
        for k, v in state0[1].items():
            if isinstance(v, dict):
                for n, t in v.items():
                    opt[k][n].copy_(t)
            else:
                opt[k].copy_(v)
    return restore


def train_phase(torch, dev, card, label, mod, cfg, params, batch, seq,
                seed, per_step):
    """One family's train step at full width (phases 3 and 4): step 1
    against the plain versions, 5-step trajectories, 10 timed steps with
    the launches per step asserted equal to `per_step`, a profile.
    `mod` is models.gpt or models.llama. Returns (launches over the 10
    timed steps, the "train" line, the tokens, the kernels' 5-step
    trajectory)."""
    from paddle_tpu_torch.models.gpt import init_opt_state
    opt = init_opt_state(params)
    tokens = train_tokens(torch, dev, cfg, batch, seq, seed)
    restore = host_state(params, opt)

    # step 1's gradients on the kernels and on their plain versions; and,
    # for the noise floor of bf16 training, the plain versions against
    # themselves with only the plain attention's kv blocks changed (256
    # instead of 512; and 64, the bf16 kernels' kv tile, so that p is
    # rounded to bf16 against running maxima as fine as the kernels')
    k_loss, k_grads = mod.loss_and_grads(params, tokens, cfg)
    with plain_versions():
        p_loss, p_grads = mod.loss_and_grads(params, tokens, cfg)
        cos = {n: _cos(k_grads[n], p_grads[n]) for n in k_grads}
        del k_grads
        floors = {}
        for block in (256, 64):
            with plain_attention_block(block):
                _, q_grads = mod.loss_and_grads(params, tokens, cfg)
            floors[block] = {n: _cos(q_grads[n], p_grads[n])
                             for n in p_grads}
            del q_grads
    floor, floor64 = floors[256], floors[64]
    del p_grads
    k_loss, p_loss = float(k_loss), float(p_loss)
    log(json.dumps({"phase": f"{label}_grads_kernel_vs_plain",
                    "loss_kernel": k_loss, "loss_plain": p_loss,
                    "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
                    "min_cosine": min(cos.values()),
                    "cosine_by_leaf": cos,
                    "plain_vs_plain_block256_min_cosine":
                        min(floor.values()),
                    "plain_vs_plain_block256_cosine_by_leaf": floor,
                    "plain_vs_plain_block64_cosine_by_leaf": floor64,
                    # per leaf: the kernel's cosine beside the two floors,
                    # and the leaves where the kernel falls below each
                    "kernel_floor256_floor64_by_leaf": {
                        n: [cos[n], floor[n], floor64[n]] for n in cos},
                    "leaves_below_floor": sorted(
                        n for n in cos if cos[n] < floor[n]),
                    "leaves_below_block64_floor": sorted(
                        n for n in cos if cos[n] < floor64[n])}))
    if not math.isfinite(k_loss) or abs(k_loss - p_loss) > 2e-3 * abs(
            p_loss):
        raise AssertionError(f"{label} step-1 loss: kernel {k_loss} vs "
                             f"plain {p_loss} (tolerance 2e-3 relative)")
    bad = {n: c for n, c in cos.items() if not c >= 0.999}
    if bad:
        raise AssertionError(f"{label} step-1 gradient cosine < 0.999: "
                             f"{bad}")

    # 5 steps from the same state on the kernels, then on the plain
    # versions
    traj = {}
    for name, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", plain_versions)):
        restore()
        with ctx():
            traj[name] = [float(mod.train_step(params, opt, tokens, cfg,
                                               **ADAMW)[0])
                          for _ in range(5)]
    rel = [abs(a - b) / abs(b) for a, b in zip(traj["kernel"],
                                               traj["plain"])]
    log(json.dumps({"phase": f"{label}_trajectory",
                    "kernel": traj["kernel"], "plain": traj["plain"],
                    "rel_diff": rel}))
    if abs(traj["kernel"][0] - k_loss) > 1e-6 * abs(k_loss) + 1e-6 or \
            max(rel) > 1e-2:
        raise AssertionError(f"{label} trajectories differ: {traj}")
    restore()
    del restore
    torch.cuda.empty_cache()

    launches, line, step = timed_steps(torch, card, label, mod, cfg, params,
                                       opt, tokens, per_step)
    train_profile(torch, step, params, opt, tokens, card, label)
    return launches, line, tokens, traj["kernel"]


def timed_steps(torch, card, label, mod, cfg, params, opt, tokens, per_step,
                **extra):
    """2 warm-up and 10 timed steps through make_train_step, the counts
    set to 0 just before the timed steps and read just after, asserted
    equal to 10 x `per_step`; prints the line (step ms p50/p90,
    tokens/s, MFU, peak memory, the warm-up losses, `extra`). Returns
    (launches over the 10 steps, the line, the step function)."""
    from paddle_tpu_torch.cost_model import train_flops_per_token
    from paddle_tpu_torch.models.facade import make_train_step
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    n_params = sum(p.numel() for p in params.values())
    step = make_train_step(mod.train_step, cfg=cfg, **ADAMW)
    warm = [float(step(params, opt, tokens)[0]) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()                          # the main path starts
    step_ms, losses = [], []
    for _ in range(10):
        t_s = time.perf_counter()
        loss, _, _ = step(params, opt, tokens)
        losses.append(float(loss))                # waits for the step
        step_ms.append((time.perf_counter() - t_s) * 1e3)
    launches = launch_counts()                    # ... and ends
    want = {k: 10 * per_step.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{label}: launches over 10 steps {launches} "
                             f"!= {want}")
    if not all(math.isfinite(x) for x in warm + losses):
        raise AssertionError(f"{label}: non-finite losses {warm + losses}")
    p50 = statistics.median(step_ms)
    tok_s = batch * seq / (p50 / 1e3)
    fpt = train_flops_per_token(n_params, cfg.num_layers, cfg.hidden_size,
                                seq)
    line = {
        "phase": label, "card": card, "params": n_params, "batch": batch,
        "seq": seq, "remat": cfg.remat,
        "remat_policy": getattr(cfg, "remat_policy", "full"), **extra,
        "steps": 10, "step_ms": step_ms, "step_ms_p50": p50,
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "tokens_per_s": tok_s, "flops_per_token": fpt,
        "mfu": fpt * tok_s / PEAK_BF16_FLOPS,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "warmup_losses": warm, "losses": losses, "launches": launches,
        "launches_per_step": {k: v // 10 for k, v in launches.items()}}
    log(json.dumps(line))
    return launches, line, step


def training(torch, dev, card):
    """Phase 3, GPT, with the one-pass CE forced. Returns the launches
    over the 10 timed steps."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(**FULL, remat=True, remat_policy="dots")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = gpt.init_gpt_params(cfg, seed=0)
    log(f"gpt_train: params built in {time.perf_counter() - t0:.1f} s")
    with forced_registry(ce="pallas_fused"):
        launches, _, _, _ = train_phase(
            torch, dev, card, "gpt_train", gpt, cfg, params, TRAIN_BATCH,
            TRAIN_SEQ, 2, {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                           "flash_bwd_dkv": L, "fused_ce": 1})
    del params
    torch.cuda.empty_cache()
    return launches


# phase 3b: the port's counterpart of bench.py's tpu-rung variant race
# (bench.py:299-320) with the attention impl fixed to "pallas":
# (name, remat, remat_policy, batch)
RACE = [("dots", True, "dots", 8), ("full", True, "full", 8),
        ("dots_flash", True, "dots_flash", 8),
        ("offload_dots", True, "offload_dots", 8),
        ("all_but_mlp", True, "all_but_mlp", 8),
        ("all_but_mlp_b12", True, "all_but_mlp", 12),
        ("no_remat_b4", False, "full", 4), ("dots_b16", True, "dots", 16)]
# policies whose backward reruns no attention forward
ONE_FWD = ("dots_flash", "all_but_mlp")
ROUTE_LAYERS = 4
# the race's depth: half the headline's 24 layers at its widths, so that
# phase 6 fits the script's time limit (PERF.md)
RACE_LAYERS = 12
# (name, env) of the route steps, each set for its own step only
ROUTES = [("default", {}), ("xla", {"PADDLE_TPU_ATTN_IMPL": "xla"}),
          ("attn_kill", {"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"}),
          ("bwd_kill", {"PADDLE_TPU_DISABLE_PALLAS_BWD": "1"}),
          ("global_kill", {"PADDLE_TPU_DISABLE_PALLAS": "1"}),
          ("splash", {"PADDLE_TPU_ATTN_IMPL": "splash"}),
          ("jax_flash", {"PADDLE_TPU_ATTN_IMPL": "jax_flash"}),
          ("default_again", {})]


@contextlib.contextmanager
def env_set(**env):
    """Set environment variables for the body; restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def step_launches(L, remat, policy, attn=True, bwd=True, ce=True):
    """Kernel launches of one GPT step on the default CE route."""
    fwd = L if not remat or policy in ONE_FWD else 2 * L
    return {"flash_fwd": fwd if attn else 0,
            "flash_bwd_dq": L if attn and bwd else 0,
            "flash_bwd_dkv": L if attn and bwd else 0,
            "ce_fwd": 1 if ce else 0, "ce_bwd": 1 if ce else 0}


def race(torch, dev, card):
    """Phase 3b: the GPT step at the headline widths, RACE_LAYERS deep,
    under each variant of RACE (2 warm-up and 10 timed steps each, from
    one starting state
    and seed-2 tokens, the CE and the update on their default routes),
    each variant's flash launches asserted and its first loss at batch 8
    held to "dots"'s within phase 3's tolerance across runs; a variant
    that runs out of device memory is printed as OOM and the race goes
    on. Then one step at ROUTE_LAYERS layers under each of ROUTES.
    Returns the launches over every timed and route step."""
    import dataclasses
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.losses import ce_route
    from paddle_tpu_torch.models.remat import HOST_POOL
    base = gpt.GPTConfig(**dict(FULL, num_layers=RACE_LAYERS))
    L = base.num_layers
    params = gpt.init_gpt_params(base, seed=0)
    opt = gpt.init_opt_state(params)
    restore = host_state(params, opt)
    total = {}
    results, first = {}, {}
    for name, remat, policy, batch in RACE:
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        restore()
        HOST_POOL.clear()
        tokens = train_tokens(torch, dev, cfg, batch, TRAIN_SEQ, 2)
        oom = None
        try:
            launches, line, step = timed_steps(
                torch, card, "gpt_race", gpt, cfg, params, opt, tokens,
                step_launches(L, remat, policy), variant=name)
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e)[:200]
        if oom is not None:
            # freed outside the handler, whose traceback holds the step
            log(json.dumps({"phase": "gpt_race", "card": card,
                            "variant": name, "batch": batch, "oom": True,
                            "error": oom}))
            del tokens
            gc.collect()
            torch.cuda.empty_cache()
            continue
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        line = {"variant": name, "pinned_host_bytes":
                HOST_POOL.pinned_bytes, **line}
        train_profile(torch, step, params, opt, tokens, card,
                      f"gpt_race_{name}", n_steps=1)
        results[name] = line
        if batch == TRAIN_BATCH:
            first[name] = line["warmup_losses"][0]
        log(json.dumps({"phase": "gpt_race_variant", "variant": name,
                        "batch": batch, "step_ms_p50": line["step_ms_p50"],
                        "step_ms_p90": line["step_ms_p90"],
                        "tokens_per_s": line["tokens_per_s"],
                        "mfu": line["mfu"],
                        "peak_bytes": line["max_memory_allocated_bytes"],
                        "pinned_host_bytes": line["pinned_host_bytes"],
                        "flash_per_step": {
                            k: line["launches_per_step"][k]
                            for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")},
                        "first_loss": line["warmup_losses"][0]}))
        del tokens, step
        HOST_POOL.clear()
        torch.cuda.empty_cache()
    ref = first.get("dots")
    off = {n: x for n, x in first.items()
           if ref is None or abs(x - ref) > 1e-6 * abs(ref) + 1e-6}
    if ref is None or off:
        raise AssertionError(f"gpt_race: first losses at batch "
                             f"{TRAIN_BATCH} {first} differ from dots's "
                             f"{ref}")
    best = max(results, key=lambda n: results[n]["tokens_per_s"])
    log(json.dumps({"phase": "gpt_race_best", "card": card,
                    "variant": best,
                    "tokens_per_s": results[best]["tokens_per_s"],
                    "ran": sorted(results),
                    "oom": [n for n, *_ in RACE if n not in results]}))
    del params, opt, restore
    gc.collect()
    torch.cuda.empty_cache()

    # the routes, one step each at ROUTE_LAYERS layers, remat "dots"
    cfg = dataclasses.replace(base, num_layers=ROUTE_LAYERS, remat=True,
                              remat_policy="dots")
    params = gpt.init_gpt_params(cfg, seed=0)
    opt = gpt.init_opt_state(params)
    restore = host_state(params, opt)
    tokens = train_tokens(torch, dev, cfg, TRAIN_BATCH, TRAIN_SEQ, 2)
    probe = torch.empty(0, device=dev)
    kernel_loss = None
    nl = ROUTE_LAYERS
    for name, env in ROUTES:
        restore()
        with env_set(**env):
            torch.cuda.synchronize()
            zero_launch_counts()
            loss = float(gpt.train_step(params, opt, tokens, cfg,
                                        **ADAMW)[0])
            got = launch_counts()
            route = ce_route(probe)
        attn = name not in ("xla", "attn_kill", "global_kill")
        want = {k: 0 for k in got}
        want.update(step_launches(nl, True, "dots", attn=attn,
                                  bwd=name != "bwd_kill",
                                  ce=name != "global_kill"))
        if kernel_loss is None:
            kernel_loss = loss
        # the same kernel forward gives the same loss; the plain
        # attention within phase 3's kernel-vs-plain tolerance
        tol = 1e-6 if attn else 2e-3
        ok = (got == want and math.isfinite(loss)
              and abs(loss - kernel_loss) <= tol * abs(kernel_loss)
              and route == ("jax" if name == "global_kill" else "pallas"))
        log(json.dumps({"phase": "gpt_route", "card": card, "route": name,
                        "env": env, "layers": nl, "loss": loss,
                        "loss_rel_diff_vs_default":
                            abs(loss - kernel_loss) / abs(kernel_loss),
                        "ce_route": route, "launches": got, "ok": ok}))
        if not ok:
            raise AssertionError(f"gpt route {name} ({env}): launches "
                                 f"{got} != {want}, loss {loss} vs "
                                 f"{kernel_loss} (rel {tol}), ce {route}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    del params, opt, restore, tokens
    torch.cuda.empty_cache()
    return total


def autotune_tiles(torch, dev, card):
    """Phase 3b's autotune: with PADDLE_TPU_AUTOTUNE=1 and the cache in a
    temporary directory, the bf16 forward at the GPT and the Llama train
    steps' shapes under each tile (time, error against the plain version
    within flash_tol, both tiles' bits compared); the first call a miss
    that times the candidates and caches the pick, the second a hit with
    `tuned` unchanged; an env tile outranking the cache; a foreign cache
    entry skipped and counted; an env tile the kernels lack raising.
    Returns {shape name: {tile: ms, "pick": tile}}."""
    import tempfile
    from paddle_tpu_torch.kernels import autotune
    from paddle_tpu_torch.kernels import flash_attention as fa
    ops = torch.ops.paddle_tpu_torch
    saved = (autotune._CACHE_PATH, dict(autotune._CACHE), autotune._loaded)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            env_set(PADDLE_TPU_AUTOTUNE="1"):
        autotune._CACHE_PATH = os.path.join(tmp, "autotune.json")
        autotune._CACHE.clear()
        autotune._loaded = False
        try:
            for label, (B, S, H, D, _) in (("gpt", ATTN_MAIN),
                                           ("llama", ATTN_LLAMA)):
                g = torch.Generator(device=dev).manual_seed(S + D)
                qkv = torch.randn(B, S, 3, H, D, generator=g,
                                  device=dev).to(torch.bfloat16)
                q, k, v = qkv.unbind(2)
                r_out, r_lse = fa.mha_fwd_ref(q, k, v, True)
                cands = fa.flash_block_candidates(D, q.dtype)
                row, outs = {}, {}
                for bq, bk in cands:
                    o, lse = fa.mha_fwd(q, k, v, causal=True, block_q=bq,
                                        block_k=bk)
                    torch.cuda.synchronize()
                    over = float(((o.float() - r_out.float()).abs()
                                  / flash_tol(r_out)).max())
                    lse_err = float((lse - r_lse).abs().max())
                    if not over <= 1.0 or not lse_err <= 1e-3:
                        raise AssertionError(
                            f"flash forward tile {(bq, bk)} at {label}: "
                            f"|err| / tol {over}, lse err {lse_err}")
                    ms = event_ms(torch, lambda: ops.flash_fwd(
                        q, k, v, True, S, bq, bk))
                    row[f"{bq}x{bk}"] = {"ms": ms, "err_over_tol": over,
                                         "lse_max_abs_err": lse_err}
                    outs[(bq, bk)] = (o, lse)
                (o1, l1), (o2, l2) = outs.values()
                same = torch.equal(o1.view(torch.int16),
                                   o2.view(torch.int16)) and \
                    torch.equal(l1, l2)
                st0 = autotune.autotune_status()
                fa.mha_fwd(q, k, v, causal=True)        # a miss: tunes
                st1 = autotune.autotune_status()
                sig = fa._flash_sig(q, k, True)
                pick = autotune.cached("flash_fwd", sig)
                fa.mha_fwd(q, k, v, causal=True)        # a hit
                st2 = autotune.autotune_status()
                if not (st1["tuned"] == st0["tuned"] + 1 and pick in cands
                        and st2["tuned"] == st1["tuned"]
                        and fa._fwd_blocks(q, k, True) == pick):
                    raise AssertionError(f"autotune at {label}: {st0} -> "
                                         f"{st1} -> {st2}, pick {pick}")
                other = next(c for c in cands if c != pick)
                with env_set(PADDLE_TPU_FLASH_BLOCK_Q=str(other[0])):
                    if fa._fwd_blocks(q, k, True) != other:
                        raise AssertionError("an env tile must outrank "
                                             "the cache")
                out[label] = {**row, "pick": list(pick),
                              "tiles_same_bits": same}
                log(json.dumps({"phase": "flash_fwd_tiles", "card": card,
                                "shape": [B, S, H, D], "tiles": row,
                                "same_bits_across_tiles": same,
                                "autotune_pick": list(pick),
                                "status": st2}))
                del qkv, q, k, v, r_out, r_lse, outs, o1, o2, l1, l2
            # a foreign entry (Pallas blocks) is skipped for the default
            # and counted; an env tile the kernels lack raises
            q = torch.randn(2, 256, 4, 64, device=dev).to(torch.bfloat16)
            sig = fa._flash_sig(q, q, True)
            autotune._CACHE[f"flash_fwd::{sig}"] = [512, 256]
            n0 = autotune.autotune_status()["foreign"]
            fa.mha_fwd(q, q, q, causal=True)
            n1 = autotune.autotune_status()["foreign"]
            try:
                with env_set(PADDLE_TPU_FLASH_BLOCK_Q="256"):
                    fa.mha_fwd(q, q, q, causal=True)
                raised = False
            except ValueError:
                raised = True
            persisted = json.load(open(autotune._CACHE_PATH))
            log(json.dumps({"phase": "autotune_rules", "foreign_counted":
                            n1 - n0, "env_tile_lacking_raised": raised,
                            "persisted": persisted}))
            if n1 != n0 + 1 or not raised or len(persisted) != 2:
                raise AssertionError("autotune rules: foreign "
                                     f"{n1 - n0}, raised {raised}, file "
                                     f"{persisted}")
        finally:
            autotune._CACHE_PATH = saved[0]
            autotune._CACHE.clear()
            autotune._CACHE.update(saved[1])
            autotune._loaded = saved[2]
    return out


def llama_training(torch, dev, card):
    """Phase 4, Llama at TinyLlama-1.1B widths, with the fused AdamW
    selected and the CE on its default route; then the primal-only eval
    loss. Returns (launches over the 10 timed steps, {"train": the
    timed line, "trajectory": the kernels' 5 losses from the starting
    state, "eval": the eval line})."""
    from paddle_tpu_torch.models import llama
    cfg = llama.LlamaConfig(**LLAMA, remat=True)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = llama.init_llama_params(cfg, seed=0)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    if shapes != LLAMA_LEAVES:
        raise AssertionError(f"llama leaves {shapes} != {LLAMA_LEAVES}")
    log(f"llama_train: params built in {time.perf_counter() - t0:.1f} s")
    with forced_registry(fused_update="pallas"):
        launches, train_line, tokens, traj = train_phase(
            torch, dev, card, "llama_train", llama, cfg, params,
            LLAMA_BATCH, LLAMA_SEQ, 3,
            {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
             "ce_fwd": 1, "ce_bwd": 1, "leaf_update": len(params)})

    # a primal-only call (an eval loss) launches the CE forward alone
    torch.cuda.synchronize()
    zero_launch_counts()
    t_s = time.perf_counter()
    with torch.no_grad():
        loss = float(llama.llama_loss(params, tokens, cfg))
    eval_ms = (time.perf_counter() - t_s) * 1e3
    got = launch_counts()
    want = {k: 0 for k in got}
    want.update(flash_fwd=L, ce_fwd=1)
    line = {"phase": "llama_eval_loss", "card": card, "loss": loss,
            "ms": eval_ms, "launches": got}
    log(json.dumps(line))
    if got != want or not math.isfinite(loss):
        raise AssertionError(f"eval loss under no_grad: launches {got} != "
                             f"{want}, loss {loss}")
    del params, tokens
    torch.cuda.empty_cache()
    return launches, {"train": train_line, "trajectory": traj, "eval": line}


def tick_profile(torch, eng, prompts, card, pre=""):
    """Where a decode tick's time goes: 8 slots decoding under
    torch.profiler, after their prefills and first tick: the 15 ticks
    left of 17 new tokens, or under multi-tick 4 dispatches (each a CUDA
    graph replay) of requests long enough to outlast them. Prints the
    device busy share of the window and the device time by kernel name
    (top 12); under multi-tick also each dispatch's time from CUDA
    events around it. Fails unless the profiler lists at least 99% and
    at most 100% of the int8 kernel launches the engine counts in the
    window, and under multi-tick unless every dispatch was a graph
    replay: so the replays ran `qmm_mma_kernel` (a replay of a plain
    version would list none; each capture's exact count is
    `check_launches`'s). Not exactly 100%: late in this script's process
    the profiler drops a few device records of a graphed window (3-5 of
    its ~2,480 int8 ones), while the same engine profiled in a fresh
    process lists every one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.kernels import quant_matmul as qm
    mt = eng.mt_k > 1
    n_new = 1 + 5 * eng._tick_span if mt else 17
    reqs = [eng.submit(p[:64], n_new) for p in prompts[:8]]
    eng.step()                                   # the 8 prefills
    torch.cuda.synchronize()
    c0 = dict(eng.counters)
    events = []
    if eng.mt_k > 1:
        dispatch = eng._dispatch

        def timed(sampling):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = dispatch(sampling)
            b.record()
            events.append((a, b))
            return out
        eng._dispatch = timed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n0 = qm.launches
        t0 = time.perf_counter()
        if mt:
            for _ in range(4):
                eng.step()
        else:
            eng.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eager = qm.launches - n0
    n_disp = eng.counters["decode_ticks"] - c0["decode_ticks"]
    n_replay = eng.counters["graph_replays"] - c0["graph_replays"]
    n_qmm = eng.counters["quant_matmuls"] - c0["quant_matmuls"]
    if mt:
        del eng._dispatch
        eng.drain()
    assert all(r.finish_reason == "length" for r in reqs)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (the kernels and copies themselves): the
    # operator-level rows repeat their kernels' time
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    profiled = sum(n for _, n, k in rows if "qmm_mma" in k)
    if not 0.99 * n_qmm <= profiled <= n_qmm or (
            mt and (n_replay != n_disp or eager)):
        raise AssertionError(
            f"{pre}tick_profile: the profiler lists {profiled} int8 kernel "
            f"launches, the engine counts {n_qmm} over {n_disp} dispatches "
            f"({n_replay} graph replays, {eager} eager launches)")
    out = {"phase": f"{pre}tick_profile", "card": card,
           "dispatches": n_disp, "ticks": n_disp * eng.mt_k,
           "slots": 8, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if rows else "not measured",
           "device_busy_share": busy_ms / wall_ms if rows
           else "not measured",
           "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                            "calls": n} for us, n, k in rows[:12]]}
    if eng.mt_k > 1:
        ms = [a.elapsed_time(b) for a, b in events]
        out.update({
            "graph_replays": n_replay,
            "replay_launches_profiled": profiled,
            "dispatch_event_ms": ms,
            "inside_dispatch_share": sum(ms) / wall_ms})
    log(json.dumps(out))
    return out


def family_fns(family):
    """(forward_cached, init_kv_cache, greedy_generate) of a model
    family, "gpt" or "llama"."""
    from paddle_tpu_torch.models import gpt, llama
    if family == "gpt":
        return gpt.gpt_forward_cached, gpt.init_kv_cache, gpt.greedy_generate
    return llama.llama_forward_cached, llama.init_kv_cache, \
        llama.greedy_generate


def forced_logits(torch, qmm, qp, prompt, tokens, cfg, dev, max_len,
                  family="gpt"):
    """The logits each of `tokens` is picked from on greedy_generate's
    path, the stream teacher-forced: the bucketed prompt's prefill, then
    one-token steps through the KV cache, each fed the token before it.
    prompt [T0] and tokens on the host; returns [len(tokens), V] f32."""
    from paddle_tpu_torch.models.decode import prompt_bucket
    fwd, init_cache, _ = family_fns(family)
    T0 = len(prompt)
    padded = torch.zeros((1, prompt_bucket(T0, max_len)), dtype=torch.int64,
                         device=dev)
    padded[0, :T0] = torch.as_tensor(prompt, device=dev)
    cache = init_cache(cfg, 1, max_len, device=dev)
    with torch.no_grad():
        lg, cache = fwd(qp, padded, cache, 0, cfg, qmm=qmm)
        rows = [lg[0, T0 - 1].float()]
        for i, tok in enumerate(tokens[:-1]):
            step = torch.tensor([[tok]], dtype=torch.int64, device=dev)
            lg, cache = fwd(qp, step, cache, T0 + i, cfg, qmm=qmm)
            rows.append(lg[0, -1].float())
    return torch.stack(rows)


def f64_checked(torch, qmm, qmm_ref, per_pass, keep=None, weights64=None):
    """`qmm` with every call's output held to the f64 bound on its own
    input (`f64_oracle`, with its `weights64` cache), the plain version
    (`qmm_ref`; None: not run) on the same input beside it. Returns (the
    wrapped qmm, stats): the calls, those of the
    kernel within the bound (in all and by forward, forwards counted in
    passes of `per_pass` calls), the worst ulps and bound shares of both
    versions, the first call outside the bound, and under "head" the
    last call (x, w_q, scale, y) of forward `keep`."""
    stats = {"per_pass": per_pass, "calls": 0,
             "kernel_calls_within_bound": 0,
             "within_by_forward": [], "kernel_max_ulps": 0.0,
             "kernel_max_bound_share": 0.0, "plain_max_ulps": 0.0,
             "plain_max_bound_share": 0.0, "first_outside": None}

    def checked(x, w_q, scale):
        y = qmm(x, w_q, scale)
        oracle = f64_oracle(torch, x, w_q, scale, weights64)
        kv = f64_verdict(torch, y, oracle)
        pv = kv if qmm_ref is None else f64_verdict(
            torch, qmm_ref(x, w_q, scale), oracle)
        fwd, call = divmod(stats["calls"], per_pass)
        if call == 0:
            stats["within_by_forward"].append(0)
        stats["within_by_forward"][-1] += kv["ok"]
        stats["kernel_calls_within_bound"] += kv["ok"]
        if not kv["ok"] and stats["first_outside"] is None:
            stats["first_outside"] = {
                "forward": fwd, "call": call, "M": x.numel() // x.shape[-1],
                "K": w_q.shape[0], "N": w_q.shape[1], **kv}
        for who, v in (("kernel", kv), ("plain", pv)):
            for k in ("max_ulps", "max_bound_share"):
                stats[f"{who}_{k}"] = max(stats[f"{who}_{k}"], v[k])
        if fwd == keep and call == per_pass - 1:
            stats["head"] = (x, w_q, scale, y)
        stats["calls"] += 1
        return y
    return checked, stats


def greedy_check(torch, qmm, qmm_ref, qp, prompt, cfg, dev, n=16,
                 max_len=1024, logit_tol=0.05, family="gpt"):
    """n greedy tokens from `prompt` [T0] (host ints) with the kernel
    (`qmm`) and with the plain version (`qmm_ref`), on the family's
    greedy_generate decode path (M = 1 steps, the path that splits K).
    Each stream is replayed teacher-forced through both versions
    (`forced_logits`):
    - each version's replay of its own stream gives that stream back;
    - at every step of each stream, the two versions' logits on the same
      prefix agree within `logit_tol` of the plain logits' span (the
      prefill check's tolerance), so every token of both streams comes
      from logits that agree;
    - every int8 call of the kernel's replays, the prefill and each
      step, lies within the f64 bound on its own input (`f64_checked`):
      a split dropped or doubled, or a wrong scale, is orders past it;
    - GPT: where the streams part, the first step that differs is a
      tie: the two tokens within one bf16 step (2^-7 of the larger
      logit) in both versions' logits; and on the plain stream the
      kernel differs from the plain pick nowhere else beyond such a tie.
    The dequant-matmul is the f32 sum of exact products in another order
    than the plain version's, rounded once to bf16, so logits one step
    apart can swap; past a parting the streams' prefixes differ, and the
    kernel's stream is held to the logit tolerance. Llama's 22-layer
    stack carries such rounding differences past one bf16 step before
    the head, so for Llama the partings are held to the f64 bound of
    every call instead of the one-step rule.

    report["f64_calls"] has the bound's counts and worst shares;
    report["f64_parting"] the f64 logits of the two tokens at the first
    parting (at step 2 where the streams agree) from the kernel's own
    head input, beside the kernel's, the plain version's on that input
    and the plain forward's: a measurement, not part of the verdict.
    Returns the report; report["ok"] says whether it passed."""
    greedy_generate = family_fns(family)[2]
    T0 = len(prompt)
    p = torch.as_tensor(prompt, device=dev)[None]
    gk, gr = (greedy_generate(qp, p, cfg, n, max_len=max_len, qmm=f)[
        0, T0:].tolist() for f in (qmm, qmm_ref))
    j0 = next((j for j in range(n) if gk[j] != gr[j]), None)
    at = 2 if j0 is None else j0
    per_pass = cfg.num_layers * sum(
        k.endswith("_q") and k != "head_q" for k in qp) + ("head_q" in qp)
    checked, f64 = f64_checked(torch, qmm, qmm_ref, per_pass, keep=at)

    def replay(f, stream):
        return forced_logits(torch, f, qp, prompt, stream, cfg, dev, max_len,
                             family)
    k_on_k, p_on_p = replay(checked, gk), replay(qmm_ref, gr)
    k_on_p = k_on_k if gk == gr else replay(checked, gr)
    p_on_k = p_on_p if gk == gr else replay(qmm_ref, gk)
    report = {"greedy16_kernel": gk, "greedy16_plain": gr,
              "greedy16_equal": gk == gr,
              "replays_reproduce": (k_on_k.argmax(-1).tolist() == gk
                                    and p_on_p.argmax(-1).tolist() == gr)}
    worst = 0.0
    for lk, lp in ((k_on_p, p_on_p), (k_on_k, p_on_k)):
        err = (lk - lp).abs().amax(-1) / lp.abs().amax(-1)
        worst = max(worst, float(err.max()))
    report["decode_logit_err_over_span"] = worst

    def one_step(lg, a, b):
        hi = max(float(lg[a]), float(lg[b]))
        return abs(float(lg[a]) - float(lg[b])) <= 2.0 ** -7 * abs(hi)
    steps = []
    for name, lg, stream in (("plain stream on the kernel", k_on_p, gr),
                             ("kernel stream on the plain", p_on_k, gk)):
        for j, tok in enumerate(stream):
            top = int(lg[j].argmax())
            if top != tok:
                steps.append({"replay": name, "step": j, "token": tok,
                              "argmax": top, "logits": [float(lg[j, tok]),
                                                        float(lg[j, top])],
                              "within_one_step": one_step(lg[j], tok, top)})
    report["differing_steps"] = steps
    report["f64_parting"] = f64_parting(torch, qmm_ref, f64, at, gk, gr,
                                        p_on_p, len(prompt), family)
    report["f64_calls"] = {k: v for k, v in f64.items() if k != "head"}
    f64_ok = f64["kernel_calls_within_bound"] == f64["calls"]
    report["f64_calls"]["ok"] = f64_ok
    parted = True
    if j0 is not None:
        report["first_split_step"] = j0
        if family == "gpt":
            parted = (one_step(k_on_p[j0], gk[j0], gr[j0])
                      and one_step(p_on_p[j0], gk[j0], gr[j0])
                      and all(s["within_one_step"] for s in steps
                              if s["replay"] == "plain stream on the kernel"))
    report["ok"] = (report["replays_reproduce"] and worst <= logit_tol
                    and f64_ok and parted)
    return report


def f64_parting(torch, qmm_ref, f64, step, gk, gr, p_on_p, T0, family):
    """The head's f64 logits at greedy step `step` from the kernel's own
    head input (`f64_checked`'s "head"), for the two tokens there (gk's
    and gr's, or the f64 top two where they agree), beside the kernel's,
    the plain version's on the same input and the plain forward's
    (`p_on_p`); and how that step's forward fared against the bound."""
    x, w_q, scale, y = f64["head"]
    row = T0 - 1 if step == 0 else 0             # the prefill's last real
    V = w_q.shape[1]
    y64 = f64_oracle(torch, x, w_q, scale)[0][row]
    y = y.reshape(-1, V)[row].float()
    plain_head = qmm_ref(x, w_q, scale).reshape(-1, V)[row].float()
    toks = ([gk[step], gr[step]] if gk[step] != gr[step]
            else y64.topk(2).indices.tolist())
    return {"phase": f"{'' if family == 'gpt' else family + '_'}"
                     "qmm_f64_replay",
            "family": family, "step": step, "calls": f64["per_pass"],
            "kernel_calls_within_bound":
                f64["within_by_forward"][step],
            "tokens": {str(t): {
                "f64": float(y64[t]), "kernel": float(y[t]),
                "plain_on_the_same_input": float(plain_head[t]),
                "plain_forward": float(p_on_p[step, t])} for t in toks},
            "f64_prefers": max(toks, key=lambda t: float(y64[t])),
            "plain_on_the_same_input_picks": int(plain_head.argmax())}


def serve(torch, qm, dev, card, family, cfg, params, prompts, max_len,
          per_pass):
    """One family's int8 serving phase (phases 5 and 5b): the engine over
    `prompts` (64 new tokens each, requests 3 and 11 sampled with top-k)
    on 8 slots, its launches asserted at `per_pass` a prefill and a tick;
    the prefill logits and the greedy check (with its f64 bound on every
    call) against the plain version; a tick profile; a 2-request fp
    engine. Returns (launches on the main path, summary dict)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.kernels import threefry as tf
    from paddle_tpu_torch.models.decode import prompt_bucket
    fwd, init_cache, _ = family_fns(family)
    pre = "" if family == "gpt" else family + "_"
    t0 = time.perf_counter()
    # weights drawn on the host from a seed: the engine quantizes them
    # there and uploads only the int8 tree (the fp matmul leaves are
    # dropped before they would reach the card)
    eng = ServingEngine(params, cfg, family=family, num_slots=8,
                        max_len=max_len, max_top_k=50, seed=0, quant="int8")
    st = eng.quant_stats()
    sizes = {"quant_tree_bytes": st["quant_bytes"], "fp_bytes": st["fp_bytes"],
             "int8_block_bytes": sum(
                 v.numel() for k, v in eng._params.items()
                 if k.endswith("_q") and k != "head_q"),
             "head_q_bytes": eng._params["head_q"].numel(),
             "wte_bytes": eng._params["wte"].numel()
             * eng._params["wte"].element_size(),
             "kv_cache_bytes": sum(c.numel() * c.element_size()
                                   for c in eng._cache.values()),
             "kv_cache_shape": list(eng._cache["k"].shape)}
    log(json.dumps({"phase": f"{pre}serving_build",
                    "seconds": time.perf_counter() - t0, **sizes}))
    sampled = {3: (0.8, 40), 11: (1.0, 20)}
    # warm-up: CUDA context, allocator and library handles
    eng.generate([prompts[0][:16]], 4)
    torch.cuda.synchronize()
    n_pre0 = eng.counters["prefills"]
    n_tick0 = eng.counters["decode_ticks"]
    qmm0 = eng.counters["quant_matmuls"]
    n_tick_ms0 = len(eng.tick_ms)
    n_pf_ms0 = len(eng.prefill_ms)
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()

    c0 = dict(eng.counters)
    qm.launches = 0                          # the main path starts here
    tf.launches["threefry_bits"] = 0
    tf_cap0 = tf.captured
    t_run = time.perf_counter()
    reqs = [eng.submit(p, 64, temperature=sampled.get(i, (0.0, 0))[0],
                       top_k=sampled.get(i, (0.0, 0))[1])
            for i, p in enumerate(prompts)]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = qm.launches                   # ... and ends here
    check_draws(eng, family, {k: v - c0[k] for k, v in eng.counters.items()},
                tf.launches["threefry_bits"], tf.captured - tf_cap0)

    n_pre = eng.counters["prefills"] - n_pre0
    n_tick = eng.counters["decode_ticks"] - n_tick0
    reasons = [r.finish_reason for r in reqs]
    if any(r != "length" for r in reasons):
        raise AssertionError(f"{family} finish reasons {reasons}")
    if launches != per_pass * (n_pre + n_tick) or \
            eng.counters["quant_matmuls"] - qmm0 != launches:
        raise AssertionError(
            f"{family} kernel launches {launches} != {per_pass} x ({n_pre} "
            f"prefills + {n_tick} ticks)")
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != 64 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.id}: bad tokens {toks[:8]}")
    tick_ms = list(eng.tick_ms)[n_tick_ms0:]
    pf_ms = list(eng.prefill_ms)[n_pf_ms0:]
    summary = {
        "phase": f"{pre}serving", "quant": "int8", "card": card,
        "requests": len(reqs), "new_tokens": 64 * len(reqs),
        "prompt_lens": [len(p) for p in prompts],
        "prefills": n_pre, "decode_ticks": n_tick,
        "launches": launches, "launches_per_pass": per_pass,
        "wall_s": wall, "tokens_per_s": 64 * len(reqs) / wall,
        "tick_ms_p50": statistics.median(tick_ms),
        "tick_ms_p90": float(np.percentile(tick_ms, 90)),
        "prefill_ms_p50": statistics.median(pf_ms),
        "prefill_ms_max": max(pf_ms),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_start_bytes": allocated0,
    }
    log(json.dumps(summary))
    summary["streams"] = [list(r.tokens) for r in reqs]

    # the kernel's forward against the same forward on the plain version
    qp = eng._params
    t0p = len(prompts[0])
    tb = prompt_bucket(t0p, max_len)
    padded = torch.zeros((1, tb), dtype=torch.int64, device=dev)
    padded[0, :t0p] = torch.as_tensor(prompts[0], device=dev)
    with torch.no_grad():
        lk, _ = fwd(qp, padded, init_cache(cfg, 1, tb, device=dev), 0, cfg,
                    qmm=qm.quant_matmul)
        lr, _ = fwd(qp, padded, init_cache(cfg, 1, tb, device=dev), 0, cfg,
                    qmm=qm.quant_matmul_ref)
    lk = lk[0, :t0p].float()
    lr = lr[0, :t0p].float()
    logit_err = float((lk - lr).abs().max())
    span = float(lr.abs().max())
    if not bool(torch.isfinite(lk).all()) or logit_err > 0.05 * span:
        raise AssertionError(f"{family} prefill logits: kernel vs plain max "
                             f"|err| {logit_err} > 5% of the logit span "
                             f"{span}")
    greedy = greedy_check(torch, qm.quant_matmul, qm.quant_matmul_ref, qp,
                          prompts[0], cfg, dev, max_len=max_len,
                          family=family)
    parting = greedy.pop("f64_parting")
    log(json.dumps({"phase": f"{pre}reference", "prefill_logit_max_abs_err":
                    logit_err, "logit_span": span, "prompt0_len": t0p,
                    "prompt0_bucket": tb, **greedy,
                    "engine_request0_first16": reqs[0].tokens[:16]}))
    log(json.dumps(parting))
    if not greedy["ok"]:
        raise AssertionError(f"{family} greedy check failed: "
                             f"{json.dumps(greedy)}")
    summary["profile"] = tick_profile(torch, eng, prompts, card, pre)
    del eng, qp

    # the fp engine (quant="off") shares every module but the kernel
    t0 = time.perf_counter()
    fp = ServingEngine(params, cfg, family=family, num_slots=2,
                       max_len=max_len, quant="off")
    out = fp.generate([p[:64] for p in prompts[:2]], 16)
    torch.cuda.synchronize()
    fp_reasons = [len(o) for o in out]
    if fp_reasons != [16, 16]:
        raise AssertionError(f"{family} fp engine emitted {fp_reasons}")
    log(json.dumps({"phase": f"{pre}serving_fp", "quant": "off",
                    "card": card, "requests": 2,
                    "wall_s": time.perf_counter() - t0,
                    "tick_ms_p50": statistics.median(fp.tick_ms),
                    "prefill_ms_p50": statistics.median(fp.prefill_ms)}))
    del fp
    torch.cuda.empty_cache()
    return launches, summary


def serving(torch, qm, dev, card):
    """Phase 5, GPT at the headline width: 16 requests, prompts of
    16..512 tokens (seed 1), max_len 1024. Returns (launches on the main
    path, summary dict)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    cfg = GPTConfig(**FULL)
    params = init_gpt_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 513, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    per_pass = sum(pass_calls(LEAF_KN, cfg.num_layers).values())
    return serve(torch, qm, dev, card, "gpt", cfg, params, prompts, 1024,
                 per_pass)


def llama_host_params():
    """The TinyLlama-width config and its weights, drawn on the host from
    seed 0 once for phases 5b and 5c (the draw takes ~15 s)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, init_llama_params
    cfg = LlamaConfig(**LLAMA)
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0, device="cpu")
    log(f"llama host params drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def llama_prompts(vocab):
    """Phase 5b's 16 prompts of 16..1024 tokens (seed 5)."""
    rng = np.random.default_rng(5)
    lens = rng.integers(16, 1025, size=16)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def llama_serving(torch, qm, dev, card, cfg, params):
    """Phase 5b, Llama at TinyLlama-1.1B widths: 16 requests, prompts of
    16..1024 tokens (seed 5), max_len 2048. Returns (launches on the
    main path, summary dict)."""
    prompts = llama_prompts(cfg.vocab_size)
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    return serve(torch, qm, dev, card, "llama", cfg, params, prompts, 2048,
                 per_pass)


# phase 5c: the paged and speculative Llama engines
PAGED = dict(kv_layout="paged", page_size=16, prefill_chunk=256,
             num_pages=513)
SPEC = dict(spec_decode="spec", gamma=4, draft_layers=11)
SAMPLED = {3: (0.8, 40), 11: (1.0, 20)}


def paged_prompts(vocab):
    """16 prompts (seed 7): a shared 512-token prefix and a suffix of
    16..512 tokens; request 0's suffix is 256 tokens (768 = 48 full
    pages of 16) and requests 14 and 15 repeat request 0's prompt, so
    their admission maps every page and copies the last one."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, size=512)
    lens = rng.integers(16, 513, size=16)
    lens[0] = 256
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, size=int(n))])
               for n in lens]
    prompts[14] = prompts[15] = prompts[0].copy()
    return prompts


def engine_forced_logits(torch, qmm, qp, prompt, tokens, cfg, dev, max_len,
                         layout, page_size=16, chunk=256, window=0):
    """The logits each of `tokens` is picked from on a Llama engine's own
    path, the stream teacher-forced into a one-row cache: "dense", the
    bucketed prefill into a bucket-long cache copied into a max_len row;
    "paged", the prefill in `chunk`-token chunks at absolute positions
    through a page table; then one-token steps at per-row positions.
    With `window` > 0 the last `window` tokens come from one forward of
    that many tokens, as a spec tick's verify pass makes them. prompt
    [T0] and tokens on the host; returns [len(tokens), V] f32."""
    from paddle_tpu_torch.models.decode import prompt_bucket
    from paddle_tpu_torch.models.llama import (init_kv_cache,
                                               llama_forward_cached)
    T0, n = len(prompt), len(tokens)
    window = min(window, n - 1)

    def ids(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=dev)[None]

    def at(p):
        return torch.tensor([p], dtype=torch.int64, device=dev)
    with torch.no_grad():
        if layout == "dense":
            tb = prompt_bucket(T0, max_len)
            mini = init_kv_cache(cfg, 1, tb, device=dev)
            padded = np.zeros(tb, np.int64)
            padded[:T0] = prompt
            lg, _ = llama_forward_cached(qp, ids(padded), mini, 0, cfg,
                                         qmm=qmm)
            cache = init_kv_cache(cfg, 1, max_len, device=dev)
            for key in ("k", "v"):
                cache[key][:, :, :tb] = mini[key]
            last = T0 - 1
        else:
            mp = -(-max_len // page_size)
            cache = init_kv_cache(cfg, mp + 1, page_size, device=dev)
            cache["pt"] = torch.arange(1, mp + 1, device=dev)[None]
            for start in range(0, T0, chunk):
                clen = min(chunk, T0 - start)
                padded = np.zeros(prompt_bucket(clen, max_len), np.int64)
                padded[:clen] = prompt[start:start + clen]
                lg, _ = llama_forward_cached(qp, ids(padded), cache,
                                             at(start), cfg, qmm=qmm)
            last = clen - 1
        rows = [lg[0, last].float()]
        steps = n - 1 - window
        for i in range(steps):
            lg, _ = llama_forward_cached(qp, ids([tokens[i]]), cache,
                                         at(T0 + i), cfg, qmm=qmm)
            rows.append(lg[0, -1].float())
        if window:
            lg, _ = llama_forward_cached(
                qp, ids(tokens[steps:steps + window]), cache, at(T0 + steps),
                cfg, qmm=qmm)
            rows.extend(lg[0].float())
    return torch.stack(rows)


def parting_verdict(torch, qm, qp, cfg, dev, prompt, stream_a, stream_b,
                    paths, weights64, logit_tol=0.05, own_check=True):
    """Phase 5b's verdict at the first step j0 where two greedy streams
    of one request part, each stream replayed teacher-forced (up to j0)
    along the path that made it (`paths`: (name, engine_forced_logits
    keywords) for stream_a's engine, then stream_b's):
    - every int8 call of both replays within the f64 bound on its own
      input;
    - the two paths' logits on the common prefix within `logit_tol` of
      the span at every step;
    - each replay gives its own stream back, up to `logit_tol` of the
      span: at every step its engine's token lies that close to the
      replay's top logit (a made-up token is far outside).
    A prompt whose prefix pages the engine shared is replayed from its
    first token, as the donor computed those pages. `weights64` is
    f64_oracle's cache. A sampled stream (`own_check` False) is not
    held to its replay's top logit. Returns the report; report["ok"]
    says whether it passed."""
    j0 = next(j for j in range(len(stream_a)) if stream_a[j] != stream_b[j])
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    out = {"step": j0, "tokens": [stream_a[j0], stream_b[j0]]}
    logits = []
    ok = True
    for (name, kw), stream in zip(paths, (stream_a, stream_b)):
        checked, f64 = f64_checked(torch, qm.quant_matmul, None, per_pass,
                                   weights64=weights64)
        lg = engine_forced_logits(torch, checked, qp, prompt,
                                  stream[:j0 + 1], cfg, dev, 2048, **kw)
        logits.append(lg)
        own = lg.gather(1, torch.as_tensor(stream[:j0 + 1],
                                           device=lg.device)[:, None])[:, 0]
        behind = float(((lg.amax(-1) - own) / lg.abs().amax(-1)).max())
        f64_ok = f64["kernel_calls_within_bound"] == f64["calls"]
        ok &= f64_ok and (behind <= logit_tol or not own_check)
        hi = float(lg[j0].abs().max())
        out[name] = {"calls": f64["calls"], "f64_ok": f64_ok,
                     "kernel_max_bound_share": f64["kernel_max_bound_share"],
                     "own_token_behind_top_over_span": behind,
                     "logits_at_parting": [float(lg[j0, t])
                                           for t in out["tokens"]],
                     "gap_bf16_steps": abs(float(lg[j0, stream_a[j0]]
                                                 - lg[j0, stream_b[j0]]))
                     / (2.0 ** -7 * hi)}
    la, lb = logits
    err = float(((la - lb).abs().amax(-1) / lb.abs().amax(-1)).max())
    out["logit_err_over_span"] = err
    out["ok"] = ok and err <= logit_tol
    return out


def compare_streams(torch, qm, qp, cfg, dev, prompts, got, want, label,
                    paths, sampled=SAMPLED, sampled_verdict=False,
                    strict=False):
    """Streams of two engines on the same prompts: how many agree token
    for token, and phase 5b's verdict at every greedy parting. With
    `sampled_verdict` a parting of a `sampled` request is held to it
    too, but for its own tokens, which need not be the top logit's.
    Raises unless every parting passes; with `strict`, at any parting,
    sampled or greedy."""
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    parted = [i for i in (range(len(prompts)) if sampled_verdict
                          else greedy) if got[i] != want[i]]
    if strict and any(a != b for a, b in zip(got, want)):
        raise AssertionError(f"{label}: streams part")
    t0 = time.perf_counter()
    weights64, verdicts, seen = {}, {}, {}
    for i in parted:
        # requests with one prompt and the same two streams (14 and 15
        # repeat request 0's prompt) share one verdict
        key = (prompts[i].tobytes(), tuple(got[i]), tuple(want[i]))
        if key not in seen:
            seen[key] = parting_verdict(torch, qm, qp, cfg, dev, prompts[i],
                                        got[i], want[i], paths, weights64,
                                        own_check=i not in sampled)
        verdicts[i] = seen[key]
    del weights64
    line = {"phase": f"llama_{label}_streams",
            "greedy_equal": sum(got[i] == want[i] for i in greedy),
            "greedy_requests": len(greedy),
            "sampled_equal": sum(got[i] == want[i] for i in sampled),
            "sampled_requests": len(sampled),
            "partings": verdicts, "seconds": time.perf_counter() - t0}
    log(json.dumps(line))
    bad = [i for i, v in verdicts.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"{label}: partings of requests {bad} fail the "
                             "f64 / logit verdict")
    return line


def pool_check(eng):
    """The page pool's accounting between ticks: table references equal
    the refcounts, every page but scratch is exactly one of free, cached
    and live, reservations are conserved, and no active slot maps a page
    past its position. Raises on a break; returns pages in use."""
    pool, ptab = eng._pool, eng._ptab
    refs = np.zeros(pool.num_pages, np.int64)
    refs[0] = 1
    np.add.at(refs, ptab[ptab != 0], 1)
    free, cached = set(pool.free), set(pool.cached)
    live = set(np.nonzero(pool.ref[1:] > 0)[0] + 1)
    ps = eng.page_size
    past = [i for i in np.nonzero(eng._active)[0]
            if ptab[i, -(-int(eng._positions[i]) // ps):].any()]
    if (not np.array_equal(refs, pool.ref) or free & cached or free & live
            or cached & live
            or len(free) + len(cached) + len(live) != pool.num_pages - 1
            or pool.reserved != int(eng._slot_reserve.sum()) or past):
        raise AssertionError(f"page pool accounting broke: {pool.stats()}, "
                             f"slots mapping past their position {past}")
    return len(live)


def count_warmups(torch, qm, eng):
    """The int8 launches of each eager K-tick run of a multi-tick engine
    (each flag's first dispatch, before its capture), in a list the
    caller reads; a call under capture launches nothing and is not
    listed."""
    warm = []
    run = eng._multi_ticks

    def counted(sampling):
        n0 = qm.launches
        out = run(sampling)
        if not torch.cuda.is_current_stream_capturing():
            warm.append(qm.launches - n0)
        return out
    eng._multi_ticks = counted
    return warm


def check_launches(eng, label, c, launches, per_pass, per_tick, warm,
                   captured=0):
    """The int8 launches of a run (counter deltas `c`) against the path:
    `per_pass` a prefill (a chunk, paged) and `per_tick` a tick. Under
    multi-tick only the eager dispatches launch through the wrapper,
    each flag's warm-up (K x per_tick, `warm`), and every later dispatch
    is a graph replay; each capture records K x per_tick kernel launches
    (`captured`, the wrapper's count under capture), which each replay
    runs; the engine's own count takes K x per_tick a dispatch."""
    passes = c["prefill_chunks"] if eng.paged else c["prefills"]
    k = eng.mt_k
    eager = c["decode_ticks"] if k == 1 else c["graph_captures"]
    want = per_pass * passes + k * per_tick * eager
    counted = per_pass * passes + k * per_tick * c["decode_ticks"]
    if launches != want or c["quant_matmuls"] != counted:
        raise AssertionError(
            f"{label} kernel launches {launches} != {want} ({per_pass} x "
            f"{passes} passes + {k} x {per_tick} x {eager} eager "
            f"dispatches), or the engine's count {c['quant_matmuls']} != "
            f"{counted}")
    if k > 1 and (any(n != k * per_tick for n in warm)
                  or len(warm) != c["graph_captures"]
                  or c["graph_replays"] != c["decode_ticks"]
                  - c["graph_captures"]
                  or captured != k * per_tick * c["graph_captures"]
                  or eng.counters["graph_captures"] > 2):
        raise AssertionError(
            f"{label}: warm-up launches {warm} (each {k} x {per_tick}), "
            f"{c['graph_replays']} replays of {c['decode_ticks']} "
            f"dispatches, {captured} launches captured in "
            f"{c['graph_captures']} graphs, "
            f"{eng.counters['graph_captures']} graphs in all")


# the threefry kernel's launches on the serving main paths, summed by
# `sampling_phase` over each serving phase: through the wrapper, recorded
# into CUDA graphs, and run by graph replays
DRAWS = {"launches": 0, "captured": 0, "replayed": 0}


def check_draws(eng, label, c, launches, captured):
    """The threefry kernel's launches of a main-path run (counter deltas
    `c`) against the sampler's draws: one a prefill pass that sampled
    and one a tick of a sampled dispatch. Under multi-tick only the
    eager dispatches launch through the wrapper, each sampled flag's
    warm-up (K), and each sampled capture records K, which its replays
    run. Adds the run's launches to DRAWS."""
    k = eng.mt_k
    eager = c["sampled_dispatches"] if k == 1 else c["sampled_captures"]
    want = c["sampled_passes"] + k * eager
    want_cap = 0 if k == 1 else k * c["sampled_captures"]
    if launches != want or captured != want_cap:
        raise AssertionError(
            f"{label} threefry kernel launches {launches} != {want} "
            f"({c['sampled_passes']} sampled passes + {k} x {eager} "
            f"sampled eager dispatches), or {captured} recorded under "
            f"capture != {want_cap}")
    DRAWS["launches"] += launches
    DRAWS["captured"] += captured
    if k > 1:
        DRAWS["replayed"] += k * (c["sampled_dispatches"]
                                  - c["sampled_captures"])


def run_engine(torch, qm, eng, prompts, label, card, per_pass, per_tick):
    """Drive one 5c or 5d engine over `prompts` (64 new tokens each,
    SAMPLED with top-k), step by step, with its launches asserted at
    `per_pass` a prefill (a chunk under the paged layout) and `per_tick`
    a decode tick (`check_launches`), and under the paged layout the
    pool checked after every step and empty at the end. Chunks are timed
    to a synchronize on each side (an earlier chunk makes no host pull
    of its own). Returns (streams, summary, launches)."""
    from paddle_tpu_torch.kernels import threefry as tf
    chunk_ms = []
    warm = count_warmups(torch, qm, eng) if eng.mt_k > 1 else []
    if eng.paged:
        run_chunk = eng._run_chunk

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_chunk(*args)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        eng._run_chunk = timed
    eng.generate([prompts[1][-12:]], 4)          # warm-up, registers nothing
    torch.cuda.synchronize()
    c0 = dict(eng.counters)
    n_tick_ms0, n_pf_ms0 = len(eng.tick_ms), len(eng.prefill_ms)
    n_cap0 = len(eng.capture_ms)
    del chunk_ms[:], warm[:]
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()
    peak_pages = 0

    qm.launches = 0                          # the main path starts here
    cap0 = qm.captured
    tf.launches["threefry_bits"] = 0
    tf_cap0 = tf.captured
    t_run = time.perf_counter()
    reqs = [eng.submit(p, 64, temperature=SAMPLED.get(i, (0.0, 0))[0],
                       top_k=SAMPLED.get(i, (0.0, 0))[1])
            for i, p in enumerate(prompts)]
    while eng.has_work():
        eng.step()
        if eng.paged:
            peak_pages = max(peak_pages, pool_check(eng))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = qm.launches                   # ... and ends here

    c = {k: v - c0[k] for k, v in eng.counters.items()}
    reasons = [r.finish_reason for r in reqs]
    if any(r != "length" for r in reasons):
        raise AssertionError(f"{label} finish reasons {reasons}")
    check_launches(eng, label, c, launches, per_pass, per_tick, warm,
                   qm.captured - cap0)
    check_draws(eng, label, c, tf.launches["threefry_bits"],
                tf.captured - tf_cap0)
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != 64 or toks.min() < 0 or toks.max() >= \
                eng.cfg.vocab_size:
            raise AssertionError(f"{label} request {r.id}: bad tokens")
    tick_ms = list(eng.tick_ms)[n_tick_ms0:]
    pf_ms = chunk_ms if eng.paged else list(eng.prefill_ms)[n_pf_ms0:]
    summary = {
        "phase": f"llama_{label}", "card": card, "requests": len(reqs),
        "new_tokens": 64 * len(reqs), "prefills": c["prefills"],
        "prefill_chunks": c["prefill_chunks"],
        "decode_ticks": c["decode_ticks"], "launches": launches,
        "launches_per_pass": per_pass, "launches_per_tick": per_tick,
        "wall_s": wall, "tokens_per_s": 64 * len(reqs) / wall,
        "tick_ms_p50": statistics.median(tick_ms),
        "tick_ms_p90": float(np.percentile(tick_ms, 90)),
        "prefill_ms_p50": statistics.median(pf_ms),
        "prefill_ms_max": max(pf_ms),
        "prefill_timed": "each chunk between synchronizes" if eng.paged
        else "each prefill to its host pull",
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_start_bytes": allocated0,
        "kv_cache_bytes": sum(v.numel() * v.element_size()
                              for k, v in eng._cache.items() if k != "pt"),
    }
    if eng.mt_k > 1:
        summary.update({
            "multi_tick": eng.mt_k,
            "dispatch_ms_p50": summary["tick_ms_p50"],
            "dispatch_ms_p90": summary["tick_ms_p90"],
            "ms_per_token_tick": summary["tick_ms_p50"] / eng.mt_k,
            "tokens_per_dispatch": (c["tokens_emitted"] - c["prefills"])
            / c["decode_ticks"],
            "graph_captures": c["graph_captures"],
            "graph_replays": c["graph_replays"],
            "replay_launches": c["graph_replays"] * eng.mt_k * per_tick,
            "graphs": eng.counters["graph_captures"],
            "capture_ms": eng.capture_ms[n_cap0:],
            "warmup_launches": warm, "tick_ms": "per dispatch"})
    if eng.spec:
        rate = c["spec_accepted"] / max(c["spec_proposed"], 1)
        summary.update({
            "spec_proposed": c["spec_proposed"],
            "spec_accepted": c["spec_accepted"], "acceptance_rate": rate,
            "tokens_per_tick": (c["tokens_emitted"] - c["prefills"])
            / (c["decode_ticks"] * eng.mt_k),
            "tokens_per_greedy_slot_tick": 1 + eng.spec_gamma * rate,
            "acceptance_note": "random weights: says nothing of a trained "
                               "model's acceptance or speed-up"})
    if eng.paged:
        st = eng.pool_stats()
        summary.update({"peak_pages_in_use": peak_pages, "pool": st})
        if st["pages_in_use"] or st["pages_reserved"] or \
                st["pages_free"] + st["pages_cached"] != st["num_pages"] - 1:
            raise AssertionError(f"{label}: the pool is not empty at the "
                                 f"end: {st}")
        if not (st["prefix_hits"] and st["cow_copies"]
                and st["prefill_chunks"]):
            raise AssertionError(f"{label}: no prefix hit, COW copy or "
                                 f"chunk: {st}")
    log(json.dumps(summary))
    if eng.paged or eng.mt_k > 1:
        summary["profile"] = tick_profile(torch, eng, prompts, card,
                                          f"llama_{label}_")
    return [list(r.tokens) for r in reqs], summary, launches


def paged_serving(torch, qm, dev, card, cfg, params):
    """Phase 5c: the int8 Llama engine at TinyLlama widths with the paged
    cache (PAGED: page 16, chunks of 256, 513 pages, half the dense
    equivalent), prefix sharing and copy-on-write, then with speculative
    decode (SPEC), each beside a dense engine on the same prompts
    (`paged_prompts`); streams compared, every parting held to phase 5b's
    verdict. Returns (the int8 kernel's launches {path: n}, {label:
    summary} with each engine's streams)."""
    from paddle_tpu_torch.inference import ServingEngine
    prompts = paged_prompts(cfg.vocab_size)
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    draft = sum(pass_calls(LLAMA_LEAF_KN, SPEC["draft_layers"]).values())
    spec_tick = per_pass + SPEC["gamma"] * draft        # 155 + 4 x 78
    streams, launches, summaries = {}, {}, {}
    for label, kw in (("paged", PAGED), ("dense", {"kv_layout": "dense"}),
                      ("spec", dict(PAGED, **SPEC)),
                      ("dense_spec", dict(kv_layout="dense", **SPEC))):
        t0 = time.perf_counter()
        eng = ServingEngine(params, cfg, family="llama", num_slots=8,
                            max_len=2048, max_top_k=50, seed=0, quant="int8",
                            **kw)
        log(json.dumps({"phase": f"llama_{label}_build", "knobs": kw,
                        "seconds": time.perf_counter() - t0}))
        streams[label], summaries[label], launches[label] = run_engine(
            torch, qm, eng, prompts, label, card, per_pass,
            spec_tick if eng.spec else per_pass)
        summaries[label]["streams"] = streams[label]
        # the int8 tree (the same from every build) for the verdicts
        qp = eng._params if label == "dense_spec" else None
        del eng
        gc.collect()        # the chunk timer and the engine hold each other
        torch.cuda.empty_cache()
    dense_path = {"layout": "dense"}
    paged_path = {"layout": "paged", "page_size": 16, "chunk": 256}
    for label, got, want, paths in (
            ("paged_vs_dense", "paged", "dense",
             (("paged", paged_path), ("dense", dense_path))),
            ("spec_vs_paged", "spec", "paged",
             (("verify", dict(paged_path, window=SPEC["gamma"] + 1)),
              ("paged", paged_path))),
            ("dense_spec_vs_dense", "dense_spec", "dense",
             (("verify", dict(dense_path, window=SPEC["gamma"] + 1)),
              ("dense", dense_path)))):
        compare_streams(torch, qm, qp, cfg, dev, prompts, streams[got],
                        streams[want], label, paths)
    del qp
    torch.cuda.empty_cache()
    return ({"llama_paged": launches["paged"], "llama_spec": launches["spec"]},
            summaries)


# phase 5d: K ticks a dispatch, each dispatch a CUDA graph replay, and the
# host KV tier
MT_K = 4
TIER = dict(kv_layout="paged", page_size=16, prefill_chunk=256,
            num_pages=257, multi_tick=MT_K)
TIER_BYTES = 256 << 20


@contextlib.contextmanager
def quantize_once():
    """Every serving engine of phases 5b-5d quantizes the same host-drawn
    Llama tree (~10 s on the host each): the int8 rewrite is computed
    once and handed to each build."""
    from paddle_tpu_torch.quantization import serving as qs
    real = qs.quantize_serving_params
    memo = {}

    def once(params, family):
        key = (id(params), family)
        if key not in memo:
            memo[key] = real(params, family)
        return memo[key]
    qs.quantize_serving_params = once
    try:
        yield
    finally:
        qs.quantize_serving_params = real


def multi_tick_serving(torch, qm, dev, card, cfg, params, k1):
    """Phase 5d (a)-(d): the int8 Llama engines of phases 5b and 5c at
    multi_tick=4, each dispatch after each sampling flag's warm-up a
    CUDA graph replay: (a) dense over phase 5b's requests, (b) paged and
    (c) paged spec over phase 5c's, (d) dense spec. Each run's launches
    and replays are checked (`check_launches`), its streams held to the
    K = 1 engine's of the same layout (`k1`: {label: summary with
    streams}) token for token or by phase 5b's verdict at each parting,
    sampled ones too. Returns the int8 kernel's launches {path: n} and
    its launches inside graph replays {path: {"replays": replays x K x
    the tick's calls, "profiled": those the profiler listed over the
    tick profile's replays}}."""
    from paddle_tpu_torch.inference import ServingEngine
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    draft = sum(pass_calls(LLAMA_LEAF_KN, SPEC["draft_layers"]).values())
    spec_tick = per_pass + SPEC["gamma"] * draft
    dense_path = {"layout": "dense"}
    paged_path = {"layout": "paged", "page_size": 16, "chunk": 256}
    window = SPEC["gamma"] + 1
    launches, replays = {}, {}
    for label, kw, prompts, base, path in (
            ("mt_dense", {"kv_layout": "dense"},
             llama_prompts(cfg.vocab_size), "serving", dense_path),
            ("mt_paged", PAGED, paged_prompts(cfg.vocab_size), "paged",
             paged_path),
            ("mt_spec", dict(PAGED, **SPEC), paged_prompts(cfg.vocab_size),
             "spec", dict(paged_path, window=window)),
            ("mt_dense_spec", dict(kv_layout="dense", **SPEC),
             paged_prompts(cfg.vocab_size), "dense_spec",
             dict(dense_path, window=window))):
        t0 = time.perf_counter()
        eng = ServingEngine(params, cfg, family="llama", num_slots=8,
                            max_len=2048, max_top_k=50, seed=0, quant="int8",
                            multi_tick=MT_K, **kw)
        log(json.dumps({"phase": f"llama_{label}_build",
                        "knobs": dict(kw, multi_tick=MT_K),
                        "seconds": time.perf_counter() - t0}))
        streams, summary, launches[f"llama_{label}"] = run_engine(
            torch, qm, eng, prompts, label, card, per_pass,
            spec_tick if eng.spec else per_pass)
        replays[f"llama_{label}"] = {
            "replays": summary["replay_launches"],
            "profiled": summary["profile"]["replay_launches_profiled"]}
        qp = eng._params
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        ref = k1[base]
        log(json.dumps({
            "phase": f"llama_{label}_vs_k1", "card": card,
            "tokens_per_s": summary["tokens_per_s"],
            "k1_tokens_per_s": ref["tokens_per_s"],
            "tokens_per_s_ratio": summary["tokens_per_s"]
            / ref["tokens_per_s"],
            "dispatch_ms_p50": summary["dispatch_ms_p50"],
            "ms_per_token_tick": summary["ms_per_token_tick"],
            "k1_tick_ms_p50": ref["tick_ms_p50"],
            "k1_from": "phase 5b" if base == "serving" else "phase 5c"}))
        compare_streams(torch, qm, qp, cfg, dev, prompts, streams,
                        ref["streams"], f"{label}_vs_k1",
                        (("k4", path), ("k1", path)),
                        sampled_verdict=True)
        del qp
        torch.cuda.empty_cache()
    return launches, replays


def tier_prompts(vocab):
    """The host tier's traffic (seed 11): 8 prompt families, each a
    512-token prefix of its own plus a 16..256-token suffix, 2 requests a
    family."""
    rng = np.random.default_rng(11)
    prompts = []
    for _ in range(8):
        prefix = rng.integers(0, vocab, size=512)
        for _ in range(2):
            suffix = rng.integers(0, vocab, size=int(rng.integers(16, 257)))
            prompts.append(np.concatenate([prefix, suffix]))
    return prompts


def host_tier_serving(torch, qm, dev, card, cfg, params):
    """Phase 5d (e): the paged multi-tick engine with 257 pages (a page's
    K+V is 22 x 16 x 4 x 64 x 2 x 2 = 360,448 B, and the 8 prefixes
    alone take 256 pages, so the pool cannot keep them while slots run)
    serves `tier_prompts` twice, 32 new tokens each, greedy: with a 256
    MiB host tier, without it, and with a pool of 1025 pages that keeps
    every page on the device. Checks: spills and swap-ins > 0, the tier
    engine's streams equal the 1025-page engine's token for token (a
    swapped-in page reads as a device hit would) and the tier-less
    engine's or each parting passes phase 5b's verdict, the pool after
    every step, the launches. Prints bytes, drops, ms a swapped-in page
    (CUDA events over uploads of the tier's pages onto the scratch
    page), the round-2 chunks and prefill p50 of each engine. Returns
    the int8 kernel's launches through the wrapper and inside graph
    replays (replays x K x the tick's calls)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.kernels import threefry as tf
    prompts = tier_prompts(cfg.vocab_size)
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    out, launches, replays = {}, 0, 0
    for label, kw in (("tier", dict(TIER, host_kv_bytes=TIER_BYTES)),
                      ("no_tier", TIER),
                      ("device_pool", dict(TIER, num_pages=1025))):
        eng = ServingEngine(params, cfg, family="llama", num_slots=8,
                            max_len=2048, seed=0, quant="int8", **kw)
        warm = count_warmups(torch, qm, eng)
        rounds = []
        for rnd in range(2):
            c0 = dict(eng.counters)
            n_pf0 = len(eng.prefill_ms)
            qm.launches = 0
            cap0 = qm.captured
            tf.launches["threefry_bits"] = 0
            tf_cap0 = tf.captured
            t0 = time.perf_counter()
            reqs = [eng.submit(p, 32) for p in prompts]
            while eng.has_work():
                eng.step()
                pool_check(eng)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = {k: v - c0[k] for k, v in eng.counters.items()}
            check_launches(eng, f"tier {label} round {rnd}", c,
                           qm.launches, per_pass, per_pass, warm,
                           qm.captured - cap0)
            check_draws(eng, f"tier {label} round {rnd}", c,
                        tf.launches["threefry_bits"], tf.captured - tf_cap0)
            del warm[:]
            launches += qm.launches
            replays += c["graph_replays"] * eng.mt_k * per_pass
            if any(r.finish_reason != "length" for r in reqs):
                raise AssertionError(f"tier {label}: finish reasons")
            pf = list(eng.prefill_ms)[n_pf0:]
            rounds.append({"streams": [list(r.tokens) for r in reqs],
                           "wall_s": wall, "chunks": c["prefill_chunks"],
                           "prefix_hit_pages": c["prefix_hits"],
                           "dispatches": c["decode_ticks"],
                           "prefill_ms_p50": statistics.median(pf)})
        st = eng.pool_stats()
        line = {"phase": f"llama_tier_{label}", "card": card,
                "knobs": {k: v for k, v in kw.items()},
                "rounds": [{k: v for k, v in r.items() if k != "streams"}
                           for r in rounds],
                "pool": st}
        if label == "tier":
            tier = eng._host_tier
            pairs = [tier.get(key) for key in list(tier._d)[:64]]

            def swap_in():
                for pair in pairs:
                    for name, page in zip(("k", "v"),
                                          eng._upload_pair(pair)):
                        eng._cache[name][:, 0].copy_(page)   # scratch
            line["swapin_ms_per_page"] = event_ms(torch, swap_in,
                                                  3) / len(pairs)
            line["swapin_timed"] = ("CUDA events over 3 x 64 pinned "
                                    "uploads and in-place page copies")
            led = eng.memory_ledger()
            line["ledger"] = {"kv_pool_host": led["components"][
                "kv_pool_host"], "device_total": led["total"]}
            if not (st["host_tier"]["spills"] and st["host_tier"]["swapins"]):
                raise AssertionError(f"host tier: no spill or swap-in: {st}")
            if led["components"]["kv_pool_host"] != st["host_tier"]["bytes"]:
                raise AssertionError("host tier: the ledger's kv_pool_host "
                                     "is not the tier's bytes")
        log(json.dumps(line))
        out[label] = rounds
        qp = eng._params
        del eng, reqs       # a Request holds its engine
        gc.collect()
        torch.cuda.empty_cache()
    paged_path = {"layout": "paged", "page_size": 16, "chunk": 256}
    for rnd in range(2):
        compare_streams(torch, qm, qp, cfg, dev, prompts,
                        out["tier"][rnd]["streams"],
                        out["device_pool"][rnd]["streams"],
                        f"tier_vs_device_pool_round{rnd + 1}",
                        (("tier", paged_path), ("device_pool", paged_path)),
                        sampled=(), strict=True)
        compare_streams(torch, qm, qp, cfg, dev, prompts,
                        out["tier"][rnd]["streams"],
                        out["no_tier"][rnd]["streams"],
                        f"tier_vs_no_tier_round{rnd + 1}",
                        (("tier", paged_path), ("no_tier", paged_path)),
                        sampled=())
    del qp
    torch.cuda.empty_cache()
    return launches, replays


# phase 6: the planner-driven dp×fsdp×tp train step at phase 4's
# configuration, 6a on one rank and 6b on two (SHARDED_PLANS)
# each leaf's step-1 gradient norm on two ranks against the unsharded
# one's: |ratio - 1| at most this (PERF.md §5)
GRAD_NORM_TOL = 1e-2


def lazy_opt_state(torch, params):
    """init_opt_state's tree for full `params`, its moments zero-stride
    views: a sharded step's shard_args materializes only the rank's
    block of each."""
    dev = next(iter(params.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return {"m": {k: zero.expand(p.shape) for k, p in params.items()},
            "v": {k: zero.expand(p.shape) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.float32, device=dev)}


def state_bytes(params, opt):
    """Device bytes of the params and both moment trees."""
    return sum(t.numel() * t.element_size()
               for tree in (params, opt["m"], opt["v"]) for t in tree.values())


def timed_losses(torch, step, params, opt, tokens, n):
    """n steps, each timed on the host clock up to its loss's pull."""
    losses, ms = [], []
    for _ in range(n):
        t_s = time.perf_counter()
        losses.append(float(step(params, opt, tokens)[0]))
        ms.append((time.perf_counter() - t_s) * 1e3)
    return losses, ms


def sharded_one_rank(torch, dev, card, p4):
    """Phase 6a: the sharded step on a 1-rank NCCL group, plan
    dp1×fsdp1×tp1, at phase 4's configuration from phase 4's starting
    state (seed 0, drawn again), the fused AdamW forced and the CE on
    its default route. Its 5 losses must equal phase 4's kernel
    trajectory (within 1e-6 relative; whether they agree to the bit is
    printed), its launches per step phase 4's exactly; 5 more steps
    give its p50 beside phase 4's. Returns what 6b is held to."""
    import torch.distributed as dist
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import (collective_route,
                                           init_parallel_env, plan_train)
    cfg = llama.LlamaConfig(**LLAMA, remat=True)
    init_parallel_env(backend="nccl", world_size=1)
    try:
        plan = plan_train(cfg, 1, LLAMA_BATCH, dp=1, fsdp=1, tp=1)
        mesh = plan.build_mesh()
        host = llama.init_llama_params(cfg, seed=0, device="cpu")
        tokens = train_tokens(torch, dev, cfg, LLAMA_BATCH, LLAMA_SEQ, 3)
        step = make_train_step(llama.train_step, cfg=cfg, mesh=mesh,
                               plan=plan, **ADAMW)
        params, opt, _ = step.shard_args(host, lazy_opt_state(torch, host),
                                         tokens)
        del host
        with forced_registry(fused_update="pallas"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launch_counts()                  # the main path starts
            losses, traj_ms = timed_losses(torch, step, params, opt,
                                           tokens, 5)
            launches = launch_counts()            # ... and ends
            peak = torch.cuda.max_memory_allocated()
            _, step_ms = timed_losses(torch, step, params, opt, tokens, 5)
        nbytes = state_bytes(params, opt)
        backend, route = str(dist.get_backend()), collective_route(None, dev)
        del step, params, opt, tokens
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    want4 = p4["trajectory"]
    per_step = {k: v // 5 for k, v in launches.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want4)]
    line = {"phase": "llama_sharded_1rank", "card": card,
            "plan": plan.name, "backend": backend, "route": route,
            "losses": losses, "phase4_losses": want4, "rel_diff": rel,
            "bitwise_equal": losses == want4,
            "launches": launches, "launches_per_step": per_step,
            "phase4_launches_per_step": p4["train"]["launches_per_step"],
            "step_ms": step_ms, "step_ms_p50": statistics.median(step_ms),
            "phase4_step_ms_p50": p4["train"]["step_ms_p50"],
            "state_bytes": nbytes, "max_memory_allocated_bytes": peak,
            "phase4_max_memory_allocated_bytes":
                p4["train"]["max_memory_allocated_bytes"]}
    log(json.dumps(line))
    if max(rel) > 1e-6:
        raise AssertionError(f"6a: losses {losses} != phase 4's {want4}")
    if per_step != p4["train"]["launches_per_step"] or any(
            v % 5 for v in launches.values()):
        raise AssertionError(f"6a: launches {launches} over 5 steps, phase "
                             f"4 {p4['train']['launches_per_step']} a step")
    return {"losses": losses, "per_step": per_step, "state_bytes": nbytes,
            "peak": peak, "step_ms_p50": line["step_ms_p50"],
            "launches": launches}


def handoff_profile(torch, step, params, opt, tokens):
    """One more step of the pipelined `step` with every stage handoff
    (parallel/collective.py `exchange`, as pipeline_train calls it)
    timed on the host clock between two synchronizes, so that the card
    is idle at each mark: the step's ms, each slot's handoff ms and the
    compute ms before it (from the previous mark), their sums, and the
    share of the step spent inside handoffs (this rank's measured idle
    share: waiting for its peer's slot at the rendezvous, plus the
    transfers)."""
    from paddle_tpu_torch.parallel import pipeline_train as ptr
    exchange, marks = ptr.exchange, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exchange(*args, **kw)
        torch.cuda.synchronize()
        marks.append((t0, time.perf_counter()))
        return out
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    ptr.exchange = timed
    try:
        float(step(params, opt, tokens)[0])
    finally:
        ptr.exchange = exchange
    step_ms = (time.perf_counter() - t_s) * 1e3
    handoff = [(b - a) * 1e3 for a, b in marks]
    before = [(a - p) * 1e3 for a, p in zip(
        [m[0] for m in marks], [t_s] + [m[1] for m in marks[:-1]])]
    return {"step_ms": step_ms, "handoffs": len(marks),
            "handoff_ms": handoff, "compute_ms_before": before,
            "handoff_ms_sum": sum(handoff),
            "rest_ms": step_ms - sum(handoff),
            "handoff_share": sum(handoff) / step_ms}


def _sharded_rank(rank, world, workdir, backend):
    """One rank of phase 6b, in its own process: joins the 2-rank group
    through a file store, draws phase 4's starting state on the host,
    and for each of SHARDED_PLANS runs step 1's loss and gradients (rank
    0 gathers them whole and takes each leaf's cosine and norm ratio
    against the unsharded step 1 from the same state, computed here
    first), then 5 steps with the launches counted, the kernels' shapes
    recorded and the peak read. Writes its results, with the seconds
    each part took, to workdir/rank<rank>.json."""
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % cards))
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import (collective_route,
                                           init_parallel_env, plan_train)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    torch.cuda.set_device(dev)
    init_parallel_env(backend=backend, init_method=f"file://{workdir}/store",
                      timeout_s=900)
    try:
        cfg = llama.LlamaConfig(**LLAMA, remat=True)
        host = llama.init_llama_params(cfg, seed=0, device="cpu")
        tokens = train_tokens(torch, dev, cfg, LLAMA_BATCH, LLAMA_SEQ, 3)
        out = {"rank": rank, "device": str(dev), "backend": backend,
               "route": collective_route(None, dev), "cards": cards,
               "seconds": {"start_and_draw": time.perf_counter() - t0}}
        if rank == 0:
            t_s = time.perf_counter()
            full = {k: v.to(dev) for k, v in host.items()}
            ref_loss, ref_grads = llama.loss_and_grads(full, tokens, cfg)
            out["ref_step1_loss"] = float(ref_loss)
            # kept on the host, pinned, so that the card holds no more
            # than the rank's own state while its peak is read
            ref_norms = {k: float(g.double().norm())
                         for k, g in ref_grads.items()}
            ref_grads = {k: torch.empty(g.shape, dtype=g.dtype,
                                        pin_memory=True).copy_(g)
                         for k, g in ref_grads.items()}
            del full
            torch.cuda.empty_cache()
            out["seconds"]["unsharded_step1"] = time.perf_counter() - t_s
        dist.barrier()
        for name, axes in SHARDED_PLANS.items():
            t_s = time.perf_counter()
            plan = plan_train(cfg, world, LLAMA_BATCH, **axes)
            if plan.name != name:
                raise AssertionError(f"plan {plan.name} for {name}")
            step = make_train_step(llama.train_step, cfg=cfg,
                                   mesh=plan.build_mesh(), plan=plan,
                                   **ADAMW)
            params, opt, _ = step.shard_args(
                host, lazy_opt_state(torch, host), tokens)
            hd = cfg.head_dim
            mesh = step.mesh
            row = {"plan": plan.name,
                   "q_heads": params["q_w"].shape[-1] // hd,
                   "kv_heads": params["k_w"].shape[-1] // hd,
                   "shard_shapes": {k: list(v.shape)
                                    for k, v in params.items()},
                   "state_bytes": state_bytes(params, opt)}
            secs = {"shard_args": time.perf_counter() - t_s}
            t_s = time.perf_counter()
            with forced_registry(fused_update="pallas"):
                loss1, grads = step.loss_and_grads(params, tokens)
                full = step.gather_full(grads)
                del grads
                row["step1_loss"] = float(loss1)
                if rank == 0:
                    row["cosine_by_leaf"] = {
                        k: _cos(full[k], ref_grads[k].to(dev)) for k in full}
                    row["norm_ratio_by_leaf"] = {
                        k: float(full[k].double().norm()) / ref_norms[k]
                        for k in full}
                del full
                torch.cuda.empty_cache()
                secs["step1_and_compare"] = time.perf_counter() - t_s
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t_s = time.perf_counter()
                with kernel_shapes() as shapes:
                    zero_launch_counts()          # the main path starts
                    row["losses"], row["step_ms"] = timed_losses(
                        torch, step, params, opt, tokens, 5)
                    row["launches"] = launch_counts()  # ... and ends
                row["kernel_shapes"] = shapes
                secs["five_steps"] = time.perf_counter() - t_s
                row["max_memory_allocated_bytes"] = \
                    torch.cuda.max_memory_allocated()
                if plan.pp > 1:
                    t_s = time.perf_counter()
                    row["bubble_fraction"] = step.bubble_fraction
                    row["handoff_route"] = collective_route(
                        mesh.get_group("pp"), dev)
                    row["handoff_profile"] = handoff_profile(
                        torch, step, params, opt, tokens)
                    secs["handoff_profile"] = time.perf_counter() - t_s
            row["seconds"] = secs
            out[plan.name] = row
            del step, params, opt
            torch.cuda.empty_cache()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def check_two_ranks(results, p6a, card):
    """Phase 6b's verdict from both ranks' results: per plan, step 1's
    loss within 2e-3 relative of 6a's and every gradient leaf's cosine
    >= 0.999 against the unsharded step 1 (phase 4's tolerances), its
    norm within GRAD_NORM_TOL of the unsharded one's, the 5-step
    trajectory within 1e-2 of 6a's, exactly the launches a step its plan
    gives on each rank (sharded_launches: 6a's under a 3D plan), each
    rank's heads and shard shapes, the shapes its kernels launched at
    (those phase 2 checked; none of the CE's under pp), and each rank's
    params and moments exactly the bytes of its shards
    (shard_state_bytes), at most 51% of 6a's under a 3D plan. A pp plan
    also prints its handoff route, its handoffs' times and the share of
    a step each rank spends in them (the measured idle share), and the
    step's bubble (its 1F1B timeline's, fixed by (pp, m)) must equal
    (pp-1)/(m+pp-1) and lie within 1.5x of the planner's (pp-1)/m.
    Prints one line a plan. Returns {plan: [each rank's launches]}."""
    r0 = results[0]
    shared = r0["cards"] < 2
    ref1 = p6a["losses"][0]
    out, failed = {}, {}
    for name, (q_heads, kv_heads) in SHARDED_HEADS.items():
        rows = [res[name] for res in results]
        cos = rows[0]["cosine_by_leaf"]
        ratio = rows[0]["norm_ratio_by_leaf"]
        B, S, H, D, _ = SHARDED_ATTN[name]
        want_shapes = {k: [[B, S, H, D]] for k in
                       ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        want_shapes.update({k: [list(SHARDED_CE[name])] if name in
                            SHARDED_CE else None for k in ("ce_fwd",
                                                           "ce_bwd")})
        rel = [abs(a - b) / abs(b)
               for a, b in zip(rows[0]["losses"], p6a["losses"])]
        want = {k: 5 * v for k, v in
                sharded_launches(name, p6a["per_step"]).items()}
        line = {
            "phase": "llama_sharded_2rank", "card": card, "plan": name,
            "backend": r0["backend"], "route": r0["route"],
            "cards": r0["cards"], "devices": [res["device"]
                                             for res in results],
            "shared_card": shared,
            "step1_loss": rows[0]["step1_loss"], "step1_loss_6a": ref1,
            "step1_loss_rel_diff": abs(rows[0]["step1_loss"] - ref1)
            / abs(ref1),
            "unsharded_step1_loss_rel_diff_6a": abs(
                r0["ref_step1_loss"] - ref1) / abs(ref1),
            "min_cosine": min(cos.values()), "cosine_by_leaf": cos,
            "max_norm_ratio_dev": max(abs(r - 1) for r in ratio.values()),
            "norm_ratio_by_leaf": ratio,
            "losses": rows[0]["losses"], "losses_6a": p6a["losses"],
            "rel_diff": rel, "max_rel_diff": max(rel),
            "launches_by_rank": [r["launches"] for r in rows],
            "launches_per_step_6a": p6a["per_step"],
            "heads_by_rank": [[r["q_heads"], r["kv_heads"]] for r in rows],
            "kernel_shapes_by_rank": [r["kernel_shapes"] for r in rows],
            "shard_shapes": rows[0]["shard_shapes"],
            "state_bytes_by_rank": [r["state_bytes"] for r in rows],
            "state_bytes_6a": p6a["state_bytes"],
            "max_memory_allocated_bytes_by_rank":
                [r["max_memory_allocated_bytes"] for r in rows],
            "max_memory_allocated_bytes_6a": p6a["peak"],
            "step_ms_by_rank": [r["step_ms"] for r in rows],
            "step_ms_p50_by_rank": [statistics.median(r["step_ms"][1:])
                                    for r in rows],
            "step_ms_p50_6a": p6a["step_ms_p50"],
            "seconds_by_rank": [dict(res["seconds"], **r["seconds"])
                                for res, r in zip(results, rows)],
            "timing": ("both ranks on one card over gloo: shared-card "
                       "times, no scaling" if shared else
                       "one card a rank")}
        pp = plan_pp(name)
        if pp > 1:
            m = SHARDED_PLANS[name]["microbatches"]
            line.update({
                "microbatches": m,
                "handoff_route_by_rank": [r["handoff_route"] for r in rows],
                "bubble_fraction_by_rank":
                    [r["bubble_fraction"] for r in rows],
                "bubble_schedule": (pp - 1) / (m + pp - 1),
                "bubble_planner": (pp - 1) / m,
                "handoff_profile_by_rank":
                    [r["handoff_profile"] for r in rows],
                "handoff_share_by_rank":
                    [r["handoff_profile"]["handoff_share"] for r in rows],
                "state_share_of_6a": [r["state_bytes"] / p6a["state_bytes"]
                                      for r in rows]})
        log(json.dumps(line))
        bad = []
        if not line["step1_loss_rel_diff"] <= 2e-3:
            bad.append("step-1 loss")
        if not line["min_cosine"] >= 0.999:
            bad.append(f"cosine {sorted(cos.items(), key=lambda kv: kv[1])[:3]}")
        if not line["max_norm_ratio_dev"] <= GRAD_NORM_TOL:
            bad.append(f"gradient norm ratio {ratio}")
        if not line["max_rel_diff"] <= 1e-2:
            bad.append("trajectory")
        if any(r["launches"] != want for r in rows):
            bad.append(f"launches, want {want}")
        if any((r["q_heads"], r["kv_heads"]) != (q_heads, kv_heads)
               for r in rows):
            bad.append("heads")
        if any(r["state_bytes"] != shard_state_bytes(name) for r in rows) \
                or (pp == 1 and any(r["state_bytes"] > 0.51 * p6a[
                    "state_bytes"] for r in rows)):
            bad.append(f"state bytes, want {shard_state_bytes(name)}")
        if pp > 1 and any(
                r["bubble_fraction"] != line["bubble_schedule"]
                or not max(r["bubble_fraction"], line["bubble_planner"])
                <= 1.5 * min(r["bubble_fraction"], line["bubble_planner"])
                for r in rows):
            bad.append("bubble")
        local = {k: list(v) for k, v in shard_shapes(name).items()}
        if any(r["shard_shapes"] != local for r in rows):
            bad.append(f"shard shapes, want {local}")
        # the kernels ran at the local shapes that phase 2 checked
        if any({k: r["kernel_shapes"].get(k) for k in want_shapes}
               != want_shapes for r in rows) or \
                tuple(SHARDED_ATTN[name]) not in ATTN_SHAPES or \
                (name in SHARDED_CE
                 and tuple(SHARDED_CE[name]) not in CE_PAIR_SHAPES):
            bad.append(f"kernel shapes, want {want_shapes}")
        if bad:
            failed[name] = bad
        out[name] = [r["launches"] for r in rows]
    if failed:
        raise AssertionError(f"6b: {failed}")
    return out


def sharded_two_ranks(torch, card, p6a):
    """Phase 6b: the plans of SHARDED_PLANS on two spawned ranks at 6a's
    configuration and global batch: one card a rank over NCCL with two
    or more cards; on one card both ranks share it over gloo, through
    parallel/collective.py's all-reduce route for CUDA tensors. A
    failure in a rank is this phase's failure. Returns {plan: [each
    rank's launches over its 5 steps]}."""
    import tempfile
    import torch.multiprocessing as mp
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    workdir = tempfile.mkdtemp(prefix="chip_smoke_6b_")
    try:
        mp.spawn(_sharded_rank, args=(2, workdir, backend), nprocs=2,
                 join=True)
        results = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return check_two_ranks(results, p6a, card)


def kernels_line(rows, attn_rows, ce_rows, pair_rows, upd_rows,
                 gpt_launches, llama_launches, serving_launches, f64,
                 replay_launches, race_launches, tiles, sharded, tf_rows,
                 sampler):
    """The kernels line: every kernel with its route, source, the TPU
    kernel it replaces, its launches on the main paths, and its times,
    bound and error from the kernel checks. `serving_launches` is the
    int8 kernel's {path: launches} through its wrapper,
    `replay_launches` its {path: launches inside CUDA graph replays};
    `f64` the worst of its f64 bound check; `race_launches` the train
    kernels' launches over phase 3b; `tiles` the forward's times at both
    q tiles and the autotune's picks; `sharded` the train kernels'
    {path: launches} of phase 6 (6a's 5 steps; 6b's, both ranks and
    its 3D plans summed, and its pipelined plan's); `tf_rows` the
    threefry kernel's check rows, `sampler` its launches by serving
    phase."""

    def train_paths(name):
        paths = {"gpt_train": gpt_launches[name],
                 "llama_train": llama_launches[name],
                 "gpt_race": race_launches[name]}
        paths.update({path: c[name] for path, c in sharded.items()})
        return paths
    nums = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")

    def on_shards(table, shapes, kernel):
        """{plan: the kernel's numbers at a rank's shape under it}"""
        return {name: {k: table[sh][kernel][k] for k in nums}
                for name, sh in shapes.items()}
    agg = tick_aggregate(rows, LEAF_KN, FULL["num_layers"])
    l_agg = tick_aggregate(rows, LLAMA_LEAF_KN, LLAMA["num_layers"])
    entries = [{
        "name": "quant_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "paddle_tpu/kernels/quant_matmul.py:181",
        "launches": sum(serving_launches.values()),
        "launches_by_path": serving_launches,
        "replay_launches_by_path": replay_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": agg["kernel_ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
        "library_ms": agg["library_ms"], "design": QMM_DESIGN,
        "llama_tick": {k: l_agg[k] for k in ("calls", "kernel_ms",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "f64_bound": f64,
        "per": "one GPT decode tick at M=8: 24 layers x 4 leaves + the head "
               "(97 launches); llama_tick: 22 x 7 + 1 = 155; from the "
               "kernel_check lines; launches over the 16-request serving "
               "run of each family, of phase 5c's paged and paged spec "
               "engines (467 a spec tick), and of phase 5d's multi-tick "
               "engines and host tier runs, where the wrapper counts the "
               "prefills and each sampling flag's eager warm-up dispatch "
               "(4 x 155 or 4 x 467) and the CUDA graph replays launch "
               "the rest: replay_launches_by_path, replays x 4 x the "
               "tick's calls (each capture checked to record exactly "
               "4 x the tick's calls), and for the four 5d engines the "
               "launches the profiler listed over their profiled replays, "
               "checked at 99-100% of the engine's count (the profiler "
               "drops a few records late in the process)",
    }]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    replaces = {"flash_fwd": "paddle_tpu/kernels/pallas_attention.py:119",
                "flash_bwd_dq": "paddle_tpu/kernels/pallas_attention.py:310",
                "flash_bwd_dkv":
                    "paddle_tpu/kernels/pallas_attention.py:327"}
    for name, where in replaces.items():
        main_row = attn_rows[ATTN_LLAMA][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": where,
            "launches": sum(train_paths(name).values()),
            "launches_by_path": train_paths(name),
            "max_abs_err": max(r[name]["max_abs_err"]
                               for r in attn_rows.values()),
            **{k: main_row[k] for k in keys},
            "on_shards": on_shards(attn_rows, SHARDED_ATTN, name),
            "design": main_row["design"],
            "per": "one call at the Llama train step's [4, 2048, 32, 64] "
                   "bf16 causal (the GPT step's [8, 1024, 16, 64] is in "
                   "its kernel_check line); launches over the 10 timed "
                   "steps of each train path, over phase 3b's timed "
                   "and route steps (gpt_race), and over phase 6's 5 "
                   "steps on one rank and on two (both ranks, the 3D "
                   "plans, and the pipelined plan); on_shards: at a "
                   "rank's [B, S, H, 64] under each of phase 6b's plans "
                   "(SHARDED_ATTN: a "
                   "microbatch's [1, 2048, 32, 64] under pp2), checked "
                   "as the main shape is"})
        if name == "flash_fwd":
            entries[-1]["tiles"] = tiles
            entries[-1]["tiles_note"] = (
                "ms of the forward at each (block_q x block_k) tile and "
                "the autotune's pick, at the GPT step's [8, 1024, 16, 64] "
                "and the Llama step's [4, 2048, 32, 64]; ms above is the "
                "default tile (128 x 64)")
    ce_main = ce_rows[CE_SHAPES[0]]
    entries.append({
        "name": "fused_ce", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_ce.cu",
        "replaces": "paddle_tpu/kernels/pallas_ce.py:143",
        "launches": sum(train_paths("fused_ce").values()),
        "launches_by_path": train_paths("fused_ce"),
        "max_abs_err": max(r["max_abs_err"] for r in ce_rows.values()),
        **{k: ce_main[k] for k in keys},
        "per": "one call at the GPT train step's [8192, 32768] bf16 "
               "logits; launches over the 10 timed steps of each train "
               "path (the GPT path forces this route)"})
    pair_main = pair_rows[CE_PAIR_SHAPES[0]]
    for name, where in (("ce_fwd", "paddle_tpu/kernels/pallas_ce.py:179"),
                        ("ce_bwd", "paddle_tpu/kernels/pallas_ce.py:218")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/fused_ce.cu",
            "replaces": where,
            "launches": sum(train_paths(name).values()),
            "launches_by_path": train_paths(name),
            "max_abs_err": max(r[name]["max_abs_err"]
                               for r in pair_rows.values()),
            **{k: pair_main[name][k] for k in keys},
            "on_shards": on_shards(pair_rows, SHARDED_CE, name),
            "per": "one call at the Llama train step's [8192, 32000] bf16 "
                   "logits; launches over the 10 timed steps of each "
                   "train path and phase 6's steps; on_shards: at a "
                   "rank's [T, 32000] under each of phase 6b's 3D plans "
                   "(SHARDED_CE; the pipelined step launches none)"})
    upd = upd_rows["step"]
    entries.append({
        "name": "leaf_update", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_update.cu",
        "replaces": "paddle_tpu/kernels/pallas_update.py:87",
        "launches": sum(train_paths("leaf_update").values()),
        "launches_by_path": train_paths("leaf_update"),
        "max_abs_err": max([upd["max_abs_err"]] + [
            r["max_abs_err"] for r in upd_rows["sharded"].values()]),
        **{k: upd[k] for k in keys},
        "on_shards": {name: {k: r[k] for k in nums}
                      for name, r in upd_rows["sharded"].items()},
        "per": "one Llama step's update: the 11 leaves of the "
               "TinyLlama-width tree in f32, summed (library: one "
               "torch._fused_adamw_ call over all 11); launches over the "
               "10 timed steps of each train path and phase 6's steps "
               "(on local shards); on_shards: one rank's update of its "
               "11 shards under each of phase 6b's plans (shard_shapes; "
               "under pp2 a stage's half of each stacked leaf and the "
               "whole wte and norm_f)"})
    tf_main = tf_rows[THREEFRY_SHAPES[0]]
    entries.append({
        "name": "threefry_bits", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/threefry.cu",
        "replaces": "paddle_tpu/inference/serving.py:546",
        "replaces_note": "jax.random.categorical (:546, :554): XLA's "
                         "threefry; the reference has no Pallas kernel "
                         "here",
        "launches": sum(d["launches"] for d in sampler.values()),
        "launches_by_path": {k: d["launches"] for k, d in sampler.items()},
        "captured_into_graphs": sum(d["captured"] for d in sampler.values()),
        "replay_launches": sum(d["replayed"] for d in sampler.values()),
        "max_abs_err": max(r["max_abs_err"] for r in tf_rows.values()),
        **{k: tf_main[k] for k in keys},
        "llama_draw": {k: tf_rows[THREEFRY_SHAPES[1]][k] for k in nums},
        "design": THREEFRY_DESIGN,
        "per": "one draw of the sampled decode tick at GPT's [8, 32768] "
               "(llama_draw: [8, 32000]), the slot keys' two fold_ins "
               "included; launches over each serving phase's main-path "
               "runs through the wrapper, exactly one a sampled tick or "
               "prefill pass (check_draws; the top-k draw reuses the full "
               "draw's first K columns); captured_into_graphs: recorded "
               "into 5d's CUDA graphs, replay_launches: run by their "
               "replays; no library call computes these bits (torch's "
               "generators are Philox)"})
    return {"kernels": entries}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmul and cuDNN (plain versions run in full f32)")

    t0 = time.perf_counter()
    _build.build(*_build.KERNELS)
    log(f"build: {time.perf_counter() - t0:.1f} s (one nvcc per source, "
        f"in parallel)")
    for name, rec in _build.build_logs.items():
        how = "cached" if rec["cached"] else f"{rec['seconds']:.1f} s"
        log(f"nvcc -Xptxas -v summary for {name} ({how}):")
        for line in ptxas_summary(rec["ptxas"]):
            log("  " + line)
    check_no_spills(_build.build_logs["flash_attention"]["ptxas"])
    check_no_spills(_build.build_logs["quant_matmul"]["ptxas"],
                    QMM_NO_SPILL)
    log("ptxas: no spills in the D = 64 bf16 attention kernels (the "
        "forward at both q tiles) or the bf16 dequant-matmul")

    # the rank's own card: LOCAL_RANK where a launcher sets it, else the
    # current device
    from paddle_tpu_torch.device import resolve_device
    dev = resolve_device(None)
    # device memory still allocated after each phase: what a later
    # phase's peak reading starts from
    held = {}
    # seconds each phase took, printed as it ends
    seconds = {"build": time.perf_counter() - t_start}

    def phase(name, fn, *args):
        t_s = time.perf_counter()
        out = fn(*args)
        held[name] = torch.cuda.memory_allocated()
        seconds[name] = time.perf_counter() - t_s
        log(f"{name}: {seconds[name]:.1f} s")
        return out
    rows = phase("kernel_check", kernel_check, torch, qm, dev)
    f64 = phase("qmm_f64_check", qmm_f64_check, torch, qm, dev)
    attn_rows = phase("attention_check", attention_check, torch, dev)
    phase("attention_oracle", attention_oracle, torch, dev)
    ce_rows = phase("ce_check", ce_check, torch, dev)
    pair_rows = phase("ce_pair_check", ce_pair_check, torch, dev)
    upd_rows = phase("update_check", update_check, torch, dev)
    tf_rows = phase("threefry_check", threefry_check, torch, dev)
    # the threefry kernel's launches by serving phase: the sum of its
    # main paths' runs, each counted from 0 where the run starts and
    # held to the sampler's draws (check_draws)
    sampler = {}

    def sampling_phase(name, fn, *args):
        DRAWS.update(launches=0, captured=0, replayed=0)
        out = phase(name, fn, *args)
        sampler[name] = dict(DRAWS)
        return out
    gpt_launches = phase("gpt_train", training, torch, dev, card)
    race_launches = phase("gpt_race", race, torch, dev, card)
    tiles = phase("flash_fwd_tiles", autotune_tiles, torch, dev, card)
    llama_launches, p4 = phase("llama_train", llama_training, torch, dev,
                               card)
    serving_launches = {
        "gpt_serving": sampling_phase("gpt_serving", serving, torch, qm,
                                      dev, card)[0]}
    # phases 5b-5d share the host-drawn TinyLlama-width weights and
    # their int8 rewrite
    lcfg, lparams = llama_host_params()
    with quantize_once():
        serving_launches["llama_serving"], k1 = sampling_phase(
            "llama_serving", llama_serving, torch, qm, dev, card, lcfg,
            lparams)
        paged_launches, k1c = sampling_phase(
            "llama_paged", paged_serving, torch, qm, dev, card, lcfg,
            lparams)
        serving_launches.update(paged_launches)
        k1c["serving"] = k1
        mt_launches, replay_launches = sampling_phase(
            "llama_multi_tick", multi_tick_serving, torch, qm, dev, card,
            lcfg, lparams, k1c)
        serving_launches.update(mt_launches)
        del k1, k1c
        serving_launches["llama_host_tier"], tier_replays = sampling_phase(
            "llama_host_tier", host_tier_serving, torch, qm, dev, card, lcfg,
            lparams)
        replay_launches["llama_host_tier"] = {"replays": tier_replays}
    del lparams
    # every serving phase with sampled requests drew through the kernel
    # (the host tier's requests are greedy)
    unsampled = [k for k in SAMPLING_PHASES
                 if not sampler[k]["launches"] + sampler[k]["captured"]]
    if unsampled:
        raise AssertionError(f"no threefry kernel launch in {unsampled}: "
                             f"{sampler}")
    p6a = phase("llama_sharded_1rank", sharded_one_rank, torch, dev, card,
                p4)
    two = phase("llama_sharded_2rank", sharded_two_ranks, torch, card, p6a)
    sharded = {"llama_sharded_1rank": p6a["launches"]}
    for path, pp in (("llama_sharded_2rank", False),
                     ("llama_pipelined_2rank", True)):
        sharded[path] = {k: sum(c[k] for name, ranks in two.items()
                                if (plan_pp(name) > 1) == pp
                                for c in ranks)
                         for k in p6a["launches"]}
    log(json.dumps({"phase": "memory_allocated_after", **held}))
    total = time.perf_counter() - t_start
    log(json.dumps({"phase": "seconds", **seconds, "total": total,
                    "limit": TIME_LIMIT_S,
                    "margin_s": TIME_LIMIT_S - total}))
    kernels = kernels_line(rows, attn_rows, ce_rows, pair_rows, upd_rows,
                           gpt_launches, llama_launches, serving_launches,
                           f64, replay_launches, race_launches, tiles,
                           sharded, tf_rows, sampler)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
