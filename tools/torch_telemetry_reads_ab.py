#!/usr/bin/env python3
"""A/B of the device telemetry's reads of a train state, on the card.

    python3 tools/torch_telemetry_reads_ab.py

At the TinyLlama-width Llama tree (chip_smoke.LLAMA_LEAVES, 1.03 G f32
parameters and as many second moments, random), times what
`instrument_train_step` reads of the state each step: the second
moments' sum twice (before and after the update), the parameters' sum
of squares and their non-finite count. Two forms, in turns (A B B A,
twice), each over 5 repetitions between CUDA events:
- A, multi-tensor: `torch._foreach_norm` over the leaves (L2 for the
  params, L1 for the moments) and `isfinite(t).logical_not_().sum()`;
- B, the form `paddle_tpu_torch/profiler/telemetry.py` ships: a
  `vector_norm` or `sum` reduction a leaf, and the count from the f32
  exponent bits (`_count_nonfinite`).
Prints the card, each form's ms a step and their bound (the params and
the moments before and after read once: 3 x 4.14 GB at 3.35 TB/s), the
two forms' values, then B's parts alone (and, over the params on their
own, the count as `numel - isfinite(t).sum()`, an `isfinite` and a
`sum`), each beside its bound. Exits non-zero
without a card.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_telemetry_reads_ab: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.profiler import telemetry
    card = cs.card_line()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    params = {k: torch.randn(s, device=dev, generator=g)
              for k, s in cs.LLAMA_LEAVES.items()}
    v = {k: torch.rand(s, device=dev, generator=g)
         for k, s in cs.LLAMA_LEAVES.items()}
    nbytes = sum(t.numel() * 4 for t in params.values())

    def multi_tensor():
        ps, vs = list(params.values()), list(v.values())
        s_old = torch.stack(torch._foreach_norm(vs, 1)).sum()
        s_new = torch.stack(torch._foreach_norm(vs, 1)).sum()
        sq = torch.stack([n * n for n in torch._foreach_norm(ps, 2)]).sum()
        nf = torch.stack([torch.isfinite(t).logical_not_().sum()
                          for t in ps]).sum()
        return s_old, s_new, sq, nf

    def per_leaf():
        s_old = telemetry.moment_sums({"v": v})["v"]
        s_new = telemetry.moment_sums({"v": v})["v"]
        return s_old, s_new, telemetry._sumsq(params), \
            telemetry._nonfinite(params)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps, [float(x) for x in out]

    runs = {"multi_tensor": [], "per_leaf": []}
    values = {}
    for name in ("multi_tensor", "per_leaf", "per_leaf", "multi_tensor") * 2:
        ms, values[name] = timed(multi_tensor if name == "multi_tensor"
                                 else per_leaf)
        runs[name].append(ms)
    # B's parts on their own, each against its own bound (bytes read once)
    parts = {
        "moment_sum": (lambda: (telemetry.moment_sums({"v": v})["v"],),
                       nbytes),
        "param_sumsq": (lambda: (telemetry._sumsq(params),), nbytes),
        "nonfinite": (lambda: (telemetry._nonfinite(params),), nbytes),
        "nonfinite_isfinite_sum": (lambda: [
            t.numel() - torch.isfinite(t).sum() for t in params.values()],
            nbytes),
        "isfinite_alone": (lambda: [torch.isfinite(t) for t in
                                    params.values()], nbytes * 5 // 4),
        "sum_alone": (lambda: [torch.sum(t) for t in params.values()],
                      nbytes)}
    split = {}
    for name, (fn, b) in parts.items():
        ms, _ = timed(lambda: [x.reshape(-1)[0] for x in fn()])
        split[name] = {"ms": ms, "bound_ms": b / cs.PEAK_BYTES * 1e3}
    line = {"tool": "torch_telemetry_reads_ab", "card": card,
            "elements": sum(t.numel() for t in params.values()),
            "ms": runs, "bound_ms": 3 * nbytes / cs.PEAK_BYTES * 1e3,
            "values": values, "parts": split}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
