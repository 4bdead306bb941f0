#!/usr/bin/env python3
"""Quick check of the port's observability on the card (ROADMAP A7 part 1).

    python3 tools/torch_observability_quick.py

Builds the train kernels (flash attention, the cross entropy, the AdamW
update; nvcc for sm_90a), runs tools/torch_sharded_quick.py's stand-in
for chip_smoke.py's phase 4 (the unsharded Llama step's 5-step
trajectory from phase 4's starting state, launches, p50 and MFU), then
chip_smoke.py's phases that carry the monitor, the spans, the flight
recorder and the device telemetry: 6a (the instrumented trajectory, its
pulls, syncs, norms, MFU, Profiler trace and the out-of-memory dump),
6c (a) (the checkpoint counters and spans), the resilience drill (its
telemetry rows, counters and dumps) and 6d (the workers' flight dumps
and train.elastic.* counters). Prints each part's seconds. A short call
for iterating on those phases; chip_smoke.py is the full check. Exits
non-zero without a card or when a build or check fails.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_observability_quick: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_smoke as cs
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.kernels import _build
    from torch_sharded_quick import phase4_standin

    t_start = time.perf_counter()
    _build.build("flash_attention", "fused_ce", "fused_update")
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    seconds = {"build": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    p4 = phase4_standin(torch, cs, dev)
    print({"unsharded": p4}, flush=True)
    seconds["phase4_standin"] = time.perf_counter() - t0
    for name, fn, args in (
            ("6a", cs.sharded_one_rank, (torch, dev, card, p4)),
            ("6c_a", cs.checkpoint_resume, (torch, dev, card, p4)),
            ("drill", cs.resilience_drill, (torch, dev, card)),
            ("6d", cs.elastic_drill, (torch, dev, card))):
        t0 = time.perf_counter()
        fn(*args)
        seconds[name] = time.perf_counter() - t0
        print({name: seconds[name]}, flush=True)
    seconds["total"] = time.perf_counter() - t_start
    print({"seconds": seconds}, flush=True)
    print("torch_observability_quick: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
