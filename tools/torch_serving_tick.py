#!/usr/bin/env python3
"""The int8 serving phase of a checkout's chip_smoke.py, alone, on one card.

    python3 tools/torch_serving_tick.py [--tree DIR] [--label NAME]

Imports chip_smoke.py and paddle_tpu_torch from DIR (default: this
checkout), builds that checkout's int8 kernel, runs its `serving` phase
(the int8 engine at the GPT width: 16 requests, 8 slots, its checks and
its tick profile) and prints one JSON line with the tick and prefill
times, tagged with the label. After the phase's own tick profile, the
same engine runs two more profiled windows of 8 ticks on 8 slots, one
greedy and one with every slot sampled (temperature 0.8, top-k 40), and
the line gives each window's host launches a tick (the CUDA runtime's
kernel-launch calls the profiler lists) and device operations a tick
(kernels and copies), so the sampler's own launches show as the
difference. To compare two commits on one card, unpack the other into
a git-ignored directory and run the two in turn in one call: parent,
change, change, parent, so drift shows beside the difference. Exits
non-zero without a card or when the phase fails.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch_window(torch, eng, prompts, temperature, top_k, ticks=8):
    """8 requests prefilled, then `ticks` decode ticks under
    torch.profiler: {"ticks", "host_launches_per_tick",
    "device_ops_per_tick", "wall_ms_per_tick"}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.submit(p[:64], ticks + 1, temperature=temperature,
                       top_k=top_k) for p in prompts[:8]]
    eng.step()                                   # the 8 prefills
    torch.cuda.synchronize()
    n0 = eng.counters["decode_ticks"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = eng.counters["decode_ticks"] - n0
    assert all(r.finish_reason == "length" for r in reqs)
    rows = prof.key_averages()
    host = sum(e.count for e in rows if e.device_type == DeviceType.CPU
               and "LaunchKernel" in e.key)
    dev = sum(e.count for e in rows if e.device_type == DeviceType.CUDA)
    return {"ticks": n, "host_launches_per_tick": host / n,
            "device_ops_per_tick": dev / n, "wall_ms_per_tick": wall_ms / n}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serving_tick: CUDA is not available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm
    assert os.path.dirname(os.path.abspath(qm.__file__)).startswith(tree)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(*_build.KERNELS)
    card = cs.card_line()
    windows = {}
    tick_profile = cs.tick_profile

    def profiled(torch, eng, prompts, card, pre=""):
        out = tick_profile(torch, eng, prompts, card, pre)
        windows["greedy"] = launch_window(torch, eng, prompts, 0.0, 0)
        windows["sampled"] = launch_window(torch, eng, prompts, 0.8, 40)
        return out
    cs.tick_profile = profiled
    _, summary = cs.serving(torch, qm, torch.device("cuda:0"), card)
    keys = ("tick_ms_p50", "tick_ms_p90", "prefill_ms_p50", "tokens_per_s",
            "decode_ticks", "launches")
    print(json.dumps({"tool": "torch_serving_tick",
                      "label": args.label or tree, "card": card,
                      **{k: summary[k] for k in keys},
                      "launch_windows": windows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
