#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit) when it fails:

1. The card's name and power limit (nvidia-smi), the torch/CUDA
   versions, and the build of every hand-written kernel from the
   sources in this checkout (one nvcc per source, all at once), with
   nvcc's -Xptxas -v register, shared-memory and spill summary; the
   D = 64 instantiations of the backward pair must not spill.
2. Kernel checks, each kernel against its plain PyTorch version on the
   card at the shapes of its main path, with kernel, plain and library
   times from CUDA events, the bound and the error (one JSON line per
   shape):
   - the fused int8 dequant-matmul, bf16 x, at the GPT serving shapes
     (M = 8 slots at decode, 128 and 512 at prefill; K, N of the qkv,
     attention-out, MLP-up, MLP-down and head matmuls);
   - the flash-attention forward and its dq and dk/dv backward kernels,
     bf16, causal, at the GPT train step's [8, 1024, 16, 64] (q, k, v
     strided views of one qkv tensor, as the GPT block makes them), a
     ragged S 1000 with kv_len 900, head dim 128, and the Llama train
     step's [4, 2048, 32, 64]; the backward pair (tensor cores on bf16)
     run twice must give the same bits, and its time is set beside
     SDPA's whole backward (vs_library);
   - the one-pass cross entropy, bf16, at [8192, 32768] (the GPT train
     step's logits) and [8192, 50304];
   - the two-pass cross entropy (forward saving the lse, backward from
     it), bf16, at [8192, 32000] (the Llama train step's logits) and
     [8192, 50257] (rows off a 16-byte boundary), the backward at
     g = 1/T (the mean loss) and g = 1;
   - the AdamW leaf update, f32, at each of the 11 leaf shapes of the
     TinyLlama-width tree, with torch._fused_adamw_ as the yardstick.
3. GPT training at the full width of the repo's headline configuration
   (bench.py's `tpu` rung: vocab 32768, hidden 1024, 24 layers, 16
   heads, max_seq_len 1024, batch 8 x 1024 tokens, remat "dots", bf16
   activations, f32 parameters, random weights from seed 0), with the
   registry's "ce" winner forced to "pallas_fused" (the one-pass CE) as
   the reference's tools/ablate_step.py forces its own.
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
   gradient leaf's cosine >= 0.999); from one starting state (kept on
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
   too.
6. The kernels line (all eight kernels), the card line, and as the last
   line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
   1}}.

float32 matmuls run in full float32 here: TF32 is switched off for
matmul and cuDNN, so the plain versions are exact-f32 references.
"""
import contextlib
import functools
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
    return bound_ms(2.0 * M * K * N, K * N + 2 * M * K + 2 * M * N + 4 * N)


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


def check_no_spills(report, names=("flash_bwd_dq_kernelILi64E",
                                   "flash_bwd_dkv_kernelILi64E")):
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


# (B, S, H, D, kv_len): the GPT train step's attention, a ragged S with
# a kv_len bound, head dim 128 (the 6.7B/13B head width), and the Llama
# train step's (32 query heads, the 4 KV heads repeated to match)
ATTN_SHAPES = [(8, 1024, 16, 64, None), (8, 1000, 16, 64, 900),
               (8, 1024, 8, 128, None), (4, 2048, 32, 64, None)]
ATTN_MAIN = ATTN_SHAPES[0]
ATTN_LLAMA = ATTN_SHAPES[3]
# how each attention kernel computes its products on bf16 operands
ATTN_DESIGN = {"flash_fwd": "CUDA-core f32 FMA",
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
        del again
        log(json.dumps({"phase": "flash_err_over_tol",
                        "shape": [B, S, H, D, kv_len], **over,
                        "lse_max_abs_err": lse_err,
                        "bwd_same_bits_twice": same_bits}))
        if max(over.values()) > 1.0 or lse_err > 1e-3:
            raise AssertionError(
                f"flash kernels disagree with their plain versions at "
                f"{(B, S, H, D, kv_len)}: worst |err| / tolerance {over}, "
                f"lse max |err| {lse_err} (tolerance 1e-3)")
        if not same_bits:
            raise AssertionError(
                f"flash backward differs between two runs on the same "
                f"inputs at {(B, S, H, D, kv_len)}")

        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        t_fwd = event_ms(torch, lambda: ops.flash_fwd(q, k, v, True, klen))
        t_dq = event_ms(torch, lambda: ops.flash_bwd_dq(
            q, k, v, do, lse, delta, True, klen))
        t_dkv = event_ms(torch, lambda: ops.flash_bwd_dkv(
            q, k, v, do, lse, delta, True, klen))
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
            log(json.dumps(line))
        out_rows[(B, S, H, D, kv_len)] = rows
        del qkv, q, k, v, do, out, lse, grads, r_out, r_lse, r_grads
        del lq, lk, lv, qT, kT, vT, delta
    return out_rows


CE_SHAPES = [(8192, 32768), (8192, 50304)]
CE_PAIR_SHAPES = [(8192, 32000), (8192, 50257)]


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


def update_check(torch, dev):
    """Phase 2e, the AdamW leaf update, f32, at every leaf shape of the
    TinyLlama-width tree. Returns {leaf: row} and a "step" row, the sums
    over the 11 leaves (one train step's update), whose library time is
    one torch._fused_adamw_ call over all of them."""
    from paddle_tpu_torch.kernels import fused_update as fu
    gen = torch.Generator(device=dev).manual_seed(7)
    step = torch.full((), 3.0, device=dev)
    hp = torch.stack([torch.full((), ADAMW[k], device=dev) for k in
                      ("lr", "beta1", "beta2", "eps", "weight_decay")]
                     + [1.0 - ADAMW["beta1"] ** step,
                        1.0 - ADAMW["beta2"] ** step])
    leaves, rows = {}, {}
    for name, shape in LLAMA_LEAVES.items():
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
                                 f"plain version at {name} {shape}: max "
                                 f"|err| p/m/v {errs}")
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
                      "leaf": name, "shape": list(shape), "n": n,
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
        "phase": "kernel_check", "kernel": "leaf_update", "leaf": "all 11",
        "n": n_all, "ms": sum(r["ms"] for r in rows.values()),
        "plain_ms": sum(r["plain_ms"] for r in rows.values()),
        "library_ms": t_lib,
        "library": "one torch._fused_adamw_ call over the 11 leaves (the "
                   "function behind torch.optim.AdamW(fused=True))",
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values())}
    rows["step"]["roofline_share"] = b_ms / rows["step"]["ms"]
    log(json.dumps(rows["step"]))
    del leaves, lists
    torch.cuda.empty_cache()
    return rows


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


def zero_launch_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.kernels import fused_update as fu
    for counts in (fa.launches, fce.launches, fu.launches):
        for name in counts:
            counts[name] = 0


def train_phase(torch, dev, card, label, mod, cfg, params, batch, seq,
                seed, per_step):
    """One family's train step at full width (phases 3 and 4): step 1
    against the plain versions, 5-step trajectories, 10 timed steps with
    the launches per step asserted equal to `per_step`, a profile.
    `mod` is models.gpt or models.llama. Returns (launches over the 10
    timed steps, the "train" line, the tokens)."""
    from paddle_tpu_torch.cost_model import train_flops_per_token
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.models.gpt import init_opt_state
    L = cfg.num_layers
    opt = init_opt_state(params)
    n_params = sum(p.numel() for p in params.values())
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq + 1)), device=dev)
    # the starting state waits on the host, so it takes no device memory
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

    # step 1's gradients on the kernels and on their plain versions; and,
    # for the noise floor of bf16 training, the plain versions against
    # themselves with only the plain attention's summation order changed
    # (kv blocks of 256 instead of 512)
    k_loss, k_grads = mod.loss_and_grads(params, tokens, cfg)
    with plain_versions():
        p_loss, p_grads = mod.loss_and_grads(params, tokens, cfg)
        with plain_attention_block(256):
            _, q_grads = mod.loss_and_grads(params, tokens, cfg)
    cos = {n: _cos(k_grads[n], p_grads[n]) for n in k_grads}
    floor = {n: _cos(q_grads[n], p_grads[n]) for n in p_grads}
    del k_grads, p_grads, q_grads
    k_loss, p_loss = float(k_loss), float(p_loss)
    log(json.dumps({"phase": f"{label}_grads_kernel_vs_plain",
                    "loss_kernel": k_loss, "loss_plain": p_loss,
                    "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
                    "min_cosine": min(cos.values()),
                    "cosine_by_leaf": cos,
                    "plain_vs_plain_block256_min_cosine":
                        min(floor.values()),
                    "plain_vs_plain_block256_cosine_by_leaf": floor}))
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
    del state0
    torch.cuda.empty_cache()

    step = make_train_step(mod.train_step, cfg=cfg, **ADAMW)
    for _ in range(2):                            # warm-up
        step(params, opt, tokens)
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
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    p50 = statistics.median(step_ms)
    tok_s = batch * seq / (p50 / 1e3)
    fpt = train_flops_per_token(n_params, L, cfg.hidden_size, seq)
    line = {
        "phase": label, "card": card, "params": n_params, "batch": batch,
        "seq": seq, "remat": cfg.remat,
        "remat_policy": getattr(cfg, "remat_policy", "full"), "steps": 10,
        "step_ms": step_ms, "step_ms_p50": p50,
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "tokens_per_s": tok_s, "flops_per_token": fpt,
        "mfu": fpt * tok_s / PEAK_BF16_FLOPS,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "losses": losses, "launches": launches,
        "launches_per_step": {k: v // 10 for k, v in launches.items()}}
    log(json.dumps(line))
    train_profile(torch, step, params, opt, tokens, card, label)
    return launches, line, tokens


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
        launches, _, _ = train_phase(
            torch, dev, card, "gpt_train", gpt, cfg, params, TRAIN_BATCH,
            TRAIN_SEQ, 2, {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                           "flash_bwd_dkv": L, "fused_ce": 1})
    del params
    torch.cuda.empty_cache()
    return launches


def llama_training(torch, dev, card):
    """Phase 4, Llama at TinyLlama-1.1B widths, with the fused AdamW
    selected and the CE on its default route; then the primal-only eval
    loss. Returns (launches over the 10 timed steps, the eval line)."""
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
        launches, _, tokens = train_phase(
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
    return launches, line


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


def kernels_line(rows, attn_rows, ce_rows, pair_rows, upd_rows,
                 gpt_launches, llama_launches, launches):
    """The kernels line: every kernel with its route, source, the TPU
    kernel it replaces, its launches on the main paths, and its times,
    bound and error from the kernel checks."""
    agg = tick_aggregate(rows, FULL["num_layers"])
    entries = [{
        "name": "quant_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "paddle_tpu/kernels/quant_matmul.py:181",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": agg["kernel_ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
        "library_ms": agg["library_ms"],
        "per": "one decode tick at M=8: 24 layers x 4 leaves + the head "
               "(97 launches), from the kernel_check lines; launches over "
               "the 16-request serving run",
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
            "launches": gpt_launches[name] + llama_launches[name],
            "launches_by_path": {"gpt_train": gpt_launches[name],
                                 "llama_train": llama_launches[name]},
            "max_abs_err": max(r[name]["max_abs_err"]
                               for r in attn_rows.values()),
            **{k: main_row[k] for k in keys},
            "design": main_row["design"],
            "per": "one call at the Llama train step's [4, 2048, 32, 64] "
                   "bf16 causal (the GPT step's [8, 1024, 16, 64] is in "
                   "its kernel_check line); launches over the 10 timed "
                   "steps of each train path"})
    ce_main = ce_rows[CE_SHAPES[0]]
    entries.append({
        "name": "fused_ce", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_ce.cu",
        "replaces": "paddle_tpu/kernels/pallas_ce.py:143",
        "launches": gpt_launches["fused_ce"] + llama_launches["fused_ce"],
        "launches_by_path": {"gpt_train": gpt_launches["fused_ce"],
                             "llama_train": llama_launches["fused_ce"]},
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
            "launches": gpt_launches[name] + llama_launches[name],
            "launches_by_path": {"gpt_train": gpt_launches[name],
                                 "llama_train": llama_launches[name]},
            "max_abs_err": max(r[name]["max_abs_err"]
                               for r in pair_rows.values()),
            **{k: pair_main[name][k] for k in keys},
            "per": "one call at the Llama train step's [8192, 32000] bf16 "
                   "logits; launches over the 10 timed steps of each "
                   "train path"})
    upd = upd_rows["step"]
    entries.append({
        "name": "leaf_update", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_update.cu",
        "replaces": "paddle_tpu/kernels/pallas_update.py:87",
        "launches": gpt_launches["leaf_update"]
        + llama_launches["leaf_update"],
        "launches_by_path": {"gpt_train": gpt_launches["leaf_update"],
                             "llama_train": llama_launches["leaf_update"]},
        "max_abs_err": upd["max_abs_err"], **{k: upd[k] for k in keys},
        "per": "one Llama step's update: the 11 leaves of the "
               "TinyLlama-width tree in f32, summed (library: one "
               "torch._fused_adamw_ call over all 11); launches over the "
               "10 timed steps of each train path"})
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
    log("ptxas: no spills in the D = 64 backward pair")

    dev = torch.device("cuda:0")
    rows = kernel_check(torch, qm, dev)
    attn_rows = attention_check(torch, dev)
    ce_rows = ce_check(torch, dev)
    pair_rows = ce_pair_check(torch, dev)
    upd_rows = update_check(torch, dev)
    gpt_launches = training(torch, dev, card)
    llama_launches, _ = llama_training(torch, dev, card)
    launches, _ = serving(torch, qm, dev, card)
    kernels = kernels_line(rows, attn_rows, ce_rows, pair_rows, upd_rows,
                           gpt_launches, llama_launches, launches)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
