#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit) when it fails:

1. The card's name and power limit (nvidia-smi), the torch/CUDA
   versions, and the build of every hand-written kernel from the
   sources in this checkout, with nvcc's -Xptxas -v register and
   shared-memory report.
2. Kernel check: the fused int8 dequant-matmul kernel against its plain
   PyTorch version on the card, with bf16 x, at the shapes of the GPT
   serving path (M = 8 slots at decode, 128 and 512 at prefill; K, N of
   the qkv, attention-out, MLP-up, MLP-down and head matmuls). One JSON
   line per shape: kernel, plain and library times from CUDA events
   over a replayed CUDA graph, the bound, and the error.
3. Serving: the int8 ServingEngine at the full width of the repo's
   headline GPT (vocab 32768, hidden 1024, 24 layers, 16 heads,
   max_seq_len 1024; bf16 activations, f32 parameters; random weights
   from a seed), 8 slots, 16 requests (prompt lengths 16..512 from a
   seeded rng, 64 new tokens each, two of them sampled with top-k).
   Every request must end with "length", and the kernel must launch
   exactly 97 times per prefill and per decode tick (24 layers x 4
   leaves + the head). One prefill's logits and 16 greedy tokens from
   the kernel are held against the same forward built on the plain
   version; 16 decode ticks run under torch.profiler (device busy share,
   device time by kernel); a 2-request fp (quant="off") engine runs too.
4. The kernels line, the card line, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

float32 matmuls run in full float32 here: TF32 is switched off for
matmul and cuDNN, so the plain versions are exact-f32 references.
"""
import json
import math
import os
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
LEAF_KN = {"qkv_w": (1024, 3072), "attn_out_w": (1024, 1024),
           "mlp_up_w": (1024, 4096), "mlp_down_w": (4096, 1024),
           "head": (1024, 32768)}
M_VALUES = (8, 128, 512)


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
    t_ops = 2.0 * M * K * N / PEAK_BF16_FLOPS
    t_bytes = (K * N + 2 * M * K + 2 * M * N + 4 * N) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def graph_ms(torch, fn, n_iters):
    """Device time per call: capture n_iters calls into a CUDA graph,
    replay it (warm), and time one replay with CUDA events."""
    s = torch.cuda.Stream()
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
    """Phase 2. Returns {(M, K, N): row}."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for M in M_VALUES:
        for K, N in LEAF_KN.values():
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
            ref = qm.quant_matmul_ref(x, ws[0], ss[0])
            torch.cuda.synchronize()
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
                   "max_abs_err": max_err,
                   "tolerance": "2^-7*|ref| + K*2^-24*(|x|@|w|)*scale"}
            log(json.dumps(row))
            rows[(M, K, N)] = row
            del ws, ss, wb
    return rows


def tick_aggregate(rows, L):
    """The 97 launches of one decode tick at M=8: L x the four block
    leaves + the head, summed per metric."""
    agg = {}
    for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms"):
        agg[key] = sum(
            (1 if leaf == "head" else L) * rows[(8,) + kn][key]
            for leaf, kn in LEAF_KN.items())
    t_ops = sum((1 if leaf == "head" else L) * 2.0 * 8 * k * n
                for leaf, (k, n) in LEAF_KN.items()) / PEAK_BF16_FLOPS
    t_bytes = sum((1 if leaf == "head" else L)
                  * (k * n + 2 * 8 * k + 2 * 8 * n + 4 * n)
                  for leaf, (k, n) in LEAF_KN.items()) / PEAK_BYTES
    agg["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
    return agg


def tick_profile(torch, eng, prompts, card):
    """Where a decode tick's time goes: 8 slots decoding 16 ticks under
    torch.profiler, after their prefills. Prints the device busy share of
    the window and the device time by kernel name (top 12)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.submit(p[:64], 17) for p in prompts[:8]]
    eng.step()                                   # the 8 prefills
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    out = {"phase": "tick_profile", "card": card, "ticks": 16, "slots": 8,
           "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if rows else "not measured",
           "device_busy_share": busy_ms / wall_ms if rows
           else "not measured",
           "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                            "calls": n} for us, n, k in rows[:12]]}
    log(json.dumps(out))


def serving(torch, qm, dev, card):
    """Phase 3. Returns (launches per main-path run, summary dict)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.decode import prompt_bucket
    from paddle_tpu_torch.models.gpt import (GPTConfig, gpt_forward_cached,
                                             greedy_generate, init_gpt_params,
                                             init_kv_cache)
    cfg = GPTConfig(**FULL)
    t0 = time.perf_counter()
    # weights drawn on the host from a seed: the engine quantizes them
    # there and uploads only the int8 tree (the fp matmul leaves are
    # dropped before they would reach the card)
    params = init_gpt_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(params, cfg, num_slots=8, max_len=1024,
                        max_top_k=50, seed=0, quant="int8")
    log(f"serving: int8 engine built in {time.perf_counter() - t0:.1f} s "
        f"({eng.quant_stats()['quant_bytes'] / 1e6:.1f} MB quantized tree "
        f"vs {eng.quant_stats()['fp_bytes'] / 1e6:.1f} MB fp)")
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 513, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
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

    qm.launches = 0                          # the main path starts here
    t_run = time.perf_counter()
    reqs = [eng.submit(p, 64, temperature=sampled.get(i, (0.0, 0))[0],
                       top_k=sampled.get(i, (0.0, 0))[1])
            for i, p in enumerate(prompts)]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = qm.launches                   # ... and ends here

    n_pre = eng.counters["prefills"] - n_pre0
    n_tick = eng.counters["decode_ticks"] - n_tick0
    reasons = [r.finish_reason for r in reqs]
    if any(r != "length" for r in reasons):
        raise AssertionError(f"finish reasons {reasons}")
    per_pass = 24 * 4 + 1
    if launches != per_pass * (n_pre + n_tick) or \
            eng.counters["quant_matmuls"] - qmm0 != launches:
        raise AssertionError(
            f"kernel launches {launches} != {per_pass} x ({n_pre} "
            f"prefills + {n_tick} ticks)")
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != 64 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.id}: bad tokens {toks[:8]}")
    tick_ms = list(eng.tick_ms)[n_tick_ms0:]
    pf_ms = list(eng.prefill_ms)[n_pf_ms0:]
    summary = {
        "phase": "serving", "quant": "int8", "card": card,
        "requests": len(reqs), "new_tokens": 64 * len(reqs),
        "prefills": n_pre, "decode_ticks": n_tick,
        "launches": launches, "launches_per_pass": per_pass,
        "wall_s": wall, "tokens_per_s": 64 * len(reqs) / wall,
        "tick_ms_p50": statistics.median(tick_ms),
        "tick_ms_p90": float(np.percentile(tick_ms, 90)),
        "prefill_ms_p50": statistics.median(pf_ms),
        "prefill_ms_max": max(pf_ms),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    log(json.dumps(summary))

    # the kernel's forward against the same forward on the plain version
    qp = eng._params
    t0p = int(lens[0])
    tb = prompt_bucket(t0p, 1024)
    padded = torch.zeros((1, tb), dtype=torch.int64, device=dev)
    padded[0, :t0p] = torch.as_tensor(prompts[0], device=dev)
    with torch.no_grad():
        lk, _ = gpt_forward_cached(qp, padded, init_kv_cache(cfg, 1, tb),
                                   0, cfg, qmm=qm.quant_matmul)
        lr, _ = gpt_forward_cached(qp, padded, init_kv_cache(cfg, 1, tb),
                                   0, cfg, qmm=qm.quant_matmul_ref)
    lk = lk[0, :t0p].float()
    lr = lr[0, :t0p].float()
    logit_err = float((lk - lr).abs().max())
    span = float(lr.abs().max())
    if not bool(torch.isfinite(lk).all()) or logit_err > 0.05 * span:
        raise AssertionError(f"prefill logits: kernel vs plain max |err| "
                             f"{logit_err} > 5% of the logit span {span}")
    prompt = torch.as_tensor(prompts[0], device=dev)[None]
    gk = greedy_generate(qp, prompt, cfg, 16, max_len=1024,
                         qmm=qm.quant_matmul)[0, t0p:].tolist()
    gr = greedy_generate(qp, prompt, cfg, 16, max_len=1024,
                         qmm=qm.quant_matmul_ref)[0, t0p:].tolist()
    log(json.dumps({"phase": "reference", "prefill_logit_max_abs_err":
                    logit_err, "logit_span": span,
                    "greedy16_kernel": gk, "greedy16_plain": gr,
                    "engine_request0_first16": reqs[0].tokens[:16]}))
    if gk != gr:
        raise AssertionError(f"greedy tokens differ: kernel {gk} vs "
                             f"plain {gr}")
    tick_profile(torch, eng, prompts, card)
    del eng

    # the fp engine (quant="off") shares every module but the kernel
    t0 = time.perf_counter()
    fp = ServingEngine(params, cfg, num_slots=2, max_len=1024, quant="off")
    out = fp.generate([p[:64] for p in prompts[:2]], 16)
    torch.cuda.synchronize()
    fp_reasons = [len(o) for o in out]
    if fp_reasons != [16, 16]:
        raise AssertionError(f"fp engine emitted {fp_reasons}")
    log(json.dumps({"phase": "serving_fp", "quant": "off", "card": card,
                    "requests": 2, "wall_s": time.perf_counter() - t0,
                    "tick_ms_p50": statistics.median(fp.tick_ms),
                    "prefill_ms_p50": statistics.median(fp.prefill_ms)}))
    return launches, summary


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
    _build.build("quant_matmul")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, rec in _build.build_logs.items():
        log(f"nvcc -Xptxas -v report for {name}:\n{rec['ptxas'].strip()}")

    dev = torch.device("cuda:0")
    rows = kernel_check(torch, qm, dev)
    launches, _ = serving(torch, qm, dev, card)

    agg = tick_aggregate(rows, FULL["num_layers"])
    kernels = {"kernels": [{
        "name": "quant_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "paddle_tpu/kernels/quant_matmul.py:181",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": agg["kernel_ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
        "library_ms": agg["library_ms"],
        "per": "one decode tick at M=8: 24 layers x 4 leaves + the head "
               "(97 launches), from the kernel_check lines",
    }]}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
