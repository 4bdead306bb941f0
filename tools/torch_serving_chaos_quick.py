#!/usr/bin/env python3
"""Quick check of the serving engine's robustness and observability on the
card (ROADMAP A7 part 2).

    python3 tools/torch_serving_chaos_quick.py

Builds the int8 dequant-matmul and the threefry kernels (nvcc for
sm_90a), then runs chip_smoke.py's phase 5f alone (`gpt_serving_chaos`)
on phase 5's GPT weights (FULL, seed 0, drawn on the host, one int8
rewrite for every engine): (a) telemetry off against on on the dense,
paged, spec and K = 4 graphed engines, (b) every engine fault scenario
of tools/chaos_serving.py but the router's, (c) a request's span tree
and the SLO burn-rate alert, (d) every run's kernel launches against
its passes and draws. Prints each part's seconds. A short call for
iterating on the phase; chip_smoke.py is the full check. Exits non-zero
without a card or when a build or check fails.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_serving_chaos_quick: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm

    t_start = time.perf_counter()
    _build.build("quant_matmul", "threefry")
    card = cs.card_line()
    print(card, flush=True)
    dev = resolve_device(None)
    seconds = {"build": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    cfg, params = cs.gpt_host_params()
    seconds["host_params"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with cs.quantize_once():
        cs.DRAWS.update(launches=0, captured=0, replayed=0)
        launches, replays = cs.gpt_serving_chaos(torch, qm, dev, card, cfg,
                                                 params)
    seconds["5f"] = time.perf_counter() - t0
    if not cs.DRAWS["launches"] + cs.DRAWS["captured"]:
        raise AssertionError(f"no threefry kernel launch in 5f: {cs.DRAWS}")
    seconds["total"] = time.perf_counter() - t_start
    print({"launches": launches, **replays, "draws": dict(cs.DRAWS),
           "seconds": seconds}, flush=True)
    print("torch_serving_chaos_quick: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
