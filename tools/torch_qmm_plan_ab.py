#!/usr/bin/env python3
"""Split-K plan A/B for the int8 dequant-matmul at decode, on one card.

    python3 tools/torch_qmm_plan_ab.py [--caps 4,8,16,0]

Builds csrc/quant_matmul.cu (or takes the cached library). For each cap
on the splits a tile (0: no cap, the grid filled to one wave of SMs), it
checks the kernel against its plain version and times it at M = 8 on
each leaf shape of both serving paths (chip_smoke.LEAF_KN, GPT's, and
chip_smoke.LLAMA_LEAF_KN, Llama's at TinyLlama widths), over cold
weights in CUDA graphs as chip_smoke.py's kernel check does, and sums
each family's decode tick (GPT 24 x 4 leaves + the head = 97 calls,
Llama 22 x 7 + 1 = 155). The caps run in the given order and then
reversed, so drift shows beside the difference. One JSON line per cap,
family and pass; the card line first. These are the numbers behind
quant_matmul.MAX_SPLITS. Exits non-zero without a card or when a check
fails.
"""
import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def leaf_times(torch, cs, qm, dev, cap, leaf_kn):
    """{leaf: (splits, kernel ms)} at M = 8 under `cap`."""
    sm = qm._sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for leaf, (K, N) in leaf_kn.items():
        plan = qm._plan(8, K, N, sm, max_splits=cap or 1 << 20)
        n_copies = max(2, math.ceil(150e6 / (K * N)))
        x = torch.randn(8, K, generator=g, device=dev).to(torch.bfloat16)
        ws = [torch.randint(-127, 128, (K, N), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(n_copies)]
        ss = [torch.rand(N, generator=g, device=dev) * 1e-2 + 1e-4
              for _ in range(n_copies)]
        y = qm._launch(x, ws[0], ss[0], plan=plan)
        ref = qm.quant_matmul_ref(x, ws[0], ss[0])
        absprod = (x.float().abs() @ ws[0].float().abs()) * ss[0]
        tol = 2.0 ** -7 * ref.float().abs() + K * 2.0 ** -24 * absprod
        if not bool(((y.float() - ref.float()).abs() <= tol).all()):
            raise AssertionError(f"cap {cap}: {leaf} disagrees with the "
                                 f"plain version")
        ms = cs.graph_ms(torch, lambda i: qm._launch(
            x, ws[i % n_copies], ss[i % n_copies], plan=plan), 4 * n_copies)
        out[leaf] = (plan.splits, ms)
        del ws, ss
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--caps", default="4,8,16,0")
    caps = [int(c) for c in ap.parse_args().caps.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("torch_qmm_plan_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm

    _build.build("quant_matmul")
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    families = (("gpt", cs.LEAF_KN, cs.FULL["num_layers"]),
                ("llama", cs.LLAMA_LEAF_KN, cs.LLAMA["num_layers"]))
    for n_pass, order in enumerate((caps, caps[::-1])):
        for cap in order:
            for family, leaf_kn, L in families:
                t = leaf_times(torch, cs, qm, dev, cap, leaf_kn)
                calls = cs.pass_calls(leaf_kn, L)
                tick = sum(calls[leaf] * ms for leaf, (_, ms) in t.items())
                print(json.dumps({
                    "tool": "torch_qmm_plan_ab", "pass": n_pass,
                    "cap": cap or "one wave", "family": family,
                    "calls": sum(calls.values()), "tick_ms": tick,
                    "leaf_us": {k: round(ms * 1e3, 3) for k, (
                        _, ms) in t.items()},
                    "splits": {k: s for k, (s, _) in t.items()}}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
