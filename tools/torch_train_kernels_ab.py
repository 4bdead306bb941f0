#!/usr/bin/env python3
"""Variants of the AdamW update and the one-pass CE kernels, side by side
on one card.

    python3 tools/torch_train_kernels_ab.py [--rounds 2] [--only NAME,...]

Builds csrc/fused_update.cu and csrc/fused_ce.cu as they are ("base")
and the edited copies VARIANTS lists (text substitutions of the source,
with the flags of kernels/_build.py, one nvcc a copy, all at once, into
build/variants/), then, for each variant, swaps its library into
`_build._LIBS` and times it at chip_smoke.py's shapes: the update as one
`leaves_update` over the 11 leaves of the full-depth TinyLlama-width
tree and over each of phase 6b's shard sets, the CE at CE_SHAPES' bf16
shapes. Before its times, each variant is held to the plain version as
chip_smoke.py holds the kernels (the update to the bit, the CE within
its tolerance). Each round runs the variants in order and then
reversed, so drift shows beside the differences. One JSON line a
variant, shape and pass; the card line first. Exits non-zero without a
card or when a build or check fails.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXPF = [("l += exp2_approx(fmaf(v[j], LOG2E, -mx2));",
         "l += expf(v[j] - mx);"),
        ("v[j] = exp2_approx(fmaf(v[j], LOG2E, -lse2));",
         "v[j] = expf(v[j] - lse);")]
UPDATE_STREAMING = [
    ("const float4 u = *reinterpret_cast<const float4*>(p);",
     "const float4 u = __ldcs(reinterpret_cast<const float4*>(p));"),
    ("const uint2 u = *reinterpret_cast<const uint2*>(p);",
     "const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));"),
    ("*reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);",
     "__stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], "
     "o[3]));"),
    ("*reinterpret_cast<uint2*>(p) = u;",
     "__stcs(reinterpret_cast<uint2*>(p), u);")]

# name -> (kernel, [(old, new)], {module attribute: value} of the wrapper)
VARIANTS = {
    "update_base": ("fused_update", [], {}),
    "update_streaming": ("fused_update", UPDATE_STREAMING, {}),
    "update_unroll2": ("fused_update", [("constexpr int UNROLL = 4;",
                                         "constexpr int UNROLL = 2;")],
                       {"CHUNK": 2048}),
    "ce_base": ("fused_ce", [], {}),
    "ce_plain_stores": ("fused_ce",
                        [("__stcs(reinterpret_cast<uint4*>(p), u);",
                          "*reinterpret_cast<uint4*>(p) = u;")], {}),
    "ce_3_buffers": ("fused_ce", [("constexpr int MAX_BUFFERS = 2;",
                                   "constexpr int MAX_BUFFERS = 3;")],
                     {"CE_MAX_BUFFERS": 3}),
    "ce_expf": ("fused_ce", EXPF, {}),
}


def build_variants(names):
    """{name: library path}, every variant's copy compiled at once."""
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.kernels import _build
    out_dir = os.path.join(HERE, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        kernel, edits, _ = VARIANTS[name]
        src = open(os.path.join(_build.CSRC, f"{kernel}.cu")).read()
        for old, new in edits:
            if old not in src:
                raise AssertionError(f"{name}: {old!r} not in {kernel}.cu")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        regs = [ln.split("ptxas info    : ")[1] for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and not ln.strip().startswith("0 bytes stack frame, 0 "
                                                "bytes spill")]
        print(json.dumps({"variant": name, "ptxas_used": regs,
                          "spills": spills}), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = lib
    return libs


def update_times(torch, cs, fu, dev, trees, hp, step):
    """{tree: (kernel ms, library ms)} of one leaves_update over each
    tree, after holding it to the plain version to the bit."""
    out = {}
    for tree, shapes in trees.items():
        gen = torch.Generator(device=dev).manual_seed(7)
        leaves = [tuple(f(shape, generator=gen, device=dev) * s for f, s in (
            (torch.randn, 0.02), (torch.randn, 1e-3), (torch.randn, 1e-4),
            (torch.rand, 1e-7))) for shape in shapes.values()]
        want = [fu.leaf_update_ref(*ops, hp) for ops in leaves]
        ps, gs, ms, vs = (list(x) for x in zip(*leaves))
        fu.leaves_update(ps, gs, ms, vs, hp)
        torch.cuda.synchronize()
        for (p, _, m, v), ref in zip(leaves, want):
            for a, b in zip((p, m, v), ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"{tree}: the update disagrees "
                                         "with its plain version")
        del want
        t_k = cs.event_ms(torch, lambda: fu.leaves_update(ps, gs, ms, vs, hp))
        t_l = cs.event_ms(torch, lambda: torch._fused_adamw_(
            ps, gs, ms, vs, [], [step] * len(ps), lr=cs.ADAMW["lr"],
            beta1=cs.ADAMW["beta1"], beta2=cs.ADAMW["beta2"],
            weight_decay=cs.ADAMW["weight_decay"], eps=cs.ADAMW["eps"],
            amsgrad=False, maximize=False))
        n = sum(p.numel() for p in ps)
        out[tree] = (t_k, t_l, cs.bound_ms(10 * n, 28 * n)[0])
        del leaves, ps, gs, ms, vs
        torch.cuda.empty_cache()
    return out


def ce_times(torch, cs, fce, dev):
    """{(T, V): (kernel ms, bound ms)} at CE_SHAPES' bf16 shapes, each
    first held to the plain version."""
    out = {}
    for T, V, dtype in cs.CE_SHAPES:
        if dtype != "bfloat16":
            continue
        g = torch.Generator(device=dev).manual_seed(V)
        x = (torch.randn(T, V, generator=g, device=dev) * 2).to(
            torch.bfloat16)
        t = torch.randint(0, V, (T,), generator=g, device=dev)
        loss, dx = fce.ce_fused(x, t)
        r_loss, r_dx = fce.ce_fused_ref(x, t)
        err = (dx.float() - r_dx.float()).abs()
        if float((loss - r_loss).abs().max()) > 1e-3 or not bool(
                (err <= 2.0 ** -7 * r_dx.float().abs() + 1e-6).all()):
            raise AssertionError(f"CE at {T}x{V} disagrees with its plain "
                                 "version")
        del r_loss, r_dx, err, loss, dx
        out[(T, V)] = (cs.event_ms(torch, lambda: fce.ce_fused(x, t)),
                       cs.bound_ms(0, 4 * T * V + 12 * T)[0])
        del x, t
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    names = [n for n in VARIANTS
             if not args.only or n in args.only.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("torch_train_kernels_ab: CUDA is not available",
              file=sys.stderr)
        return 2
    import ctypes
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.kernels import fused_update as fu
    print(cs.card_line(), flush=True)
    libs = build_variants(names)
    dev = torch.device("cuda", torch.cuda.current_device())
    step = torch.full((), 3.0, device=dev)
    hp = torch.stack([torch.full((), cs.ADAMW[k], device=dev) for k in
                      ("lr", "beta1", "beta2", "eps", "weight_decay")]
                     + [1.0 - cs.ADAMW["beta1"] ** step,
                        1.0 - cs.ADAMW["beta2"] ** step])
    trees = {"full_depth": cs.LLAMA_LEAVES,
             **{name: cs.shard_shapes(name) for name in cs.SHARDED_PLANS}}
    mods = {"fused_update": fu, "fused_ce": fce}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            kernel, _, attrs = VARIANTS[name]
            mod = mods[kernel]
            saved = {k: getattr(mod, k) for k in attrs}
            for k, v in attrs.items():
                setattr(mod, k, v)
            _build._LIBS[kernel] = ctypes.CDLL(libs[name])
            fce._RESIDENT.clear()
            try:
                if kernel == "fused_update":
                    for tree, (ms, lib, bound) in update_times(
                            torch, cs, fu, dev, trees, hp, step).items():
                        print(json.dumps({
                            "variant": name, "round": r, "tree": tree,
                            "ms": ms, "library_ms": lib, "bound_ms": bound,
                            "share": bound / ms}), flush=True)
                else:
                    for (T, V), (ms, bound) in ce_times(torch, cs, fce,
                                                        dev).items():
                        print(json.dumps({
                            "variant": name, "round": r, "shape": [T, V],
                            "plan": fce._card_plan(T, V, torch.bfloat16,
                                                   dev),
                            "ms": ms, "bound_ms": bound,
                            "share": bound / ms}), flush=True)
            finally:
                for k, v in saved.items():
                    setattr(mod, k, v)
                _build._LIBS.pop(kernel, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
