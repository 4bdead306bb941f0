#!/usr/bin/env python3
"""How many int8 kernel records torch.profiler lists over CUDA graph
replays of the multi-tick engine, against the engine's own count.

    python3 tools/torch_replay_profile_count.py [--layers N] [--label NAME]

Builds chip_smoke.py's phase 5d dense engine (its host-drawn
TinyLlama-width weights at `--layers` of 22, int8, 8 slots, max_len
2048, multi_tick=4), serves phase 5b's requests so that both sampling
flags' graphs exist, then profiles windows of 4 dispatches (each a graph
replay) in fresh requests: opened straight onto the first replay, after
0.25 s of an idle device, and behind a profiler schedule with one
warm-up step; and once through chip_smoke's own `tick_profile`. Prints
one JSON line: for each window the `qmm_mma` records the profiler
lists, the engine's int8 count and the replays. chip_smoke.py's tick
profile holds the listed count to 99-100% of the engine's; this shows
what a fresh process lists. Exits non-zero without a card.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=22)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_replay_profile_count: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    from paddle_tpu_torch.inference import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg, params = cs.llama_host_params()
    if args.layers != cfg.num_layers:
        params = {k: v[:args.layers] if v.dim() and k not in (
            "wte", "norm_f") else v for k, v in params.items()}
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    prompts = cs.llama_prompts(cfg.vocab_size)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def listed(key_averages):
        return sum(e.count for e in key_averages
                   if e.device_type == DeviceType.CUDA
                   and "qmm_mma" in e.key)

    out = {"label": args.label, "card": cs.card_line(),
           "layers": cfg.num_layers}
    with cs.quantize_once():
        eng = ServingEngine(params, cfg, family="llama", num_slots=8,
                            max_len=2048, max_top_k=50, seed=0,
                            quant="int8", multi_tick=cs.MT_K)
        eng.generate([prompts[1][-12:]], 4)
        for i, p in enumerate(prompts):
            t, k = cs.SAMPLED.get(i, (0.0, 0))
            eng.submit(p, 64, temperature=t, top_k=k)
        eng.drain()
        out["graphs"] = eng.counters["graph_captures"]

        def window(how):
            for p in prompts[:8]:
                eng.submit(p[:64], 40)
            eng.step()
            torch.cuda.synchronize()
            c0 = dict(eng.counters)
            if how == "schedule":
                got = {}

                def ready(prof):
                    got["n"] = listed(prof.key_averages())
                with profile(activities=acts,
                             schedule=schedule(wait=0, warmup=1, active=4),
                             on_trace_ready=ready) as prof:
                    for i in range(5):
                        if i == 1:
                            c0 = dict(eng.counters)
                        eng.step()
                        torch.cuda.synchronize()
                        prof.step()
                n = got["n"]
            else:
                with profile(activities=acts) as prof:
                    if how == "idle_gap":
                        torch.cuda.synchronize()
                        time.sleep(0.25)
                    for _ in range(4):
                        eng.step()
                    torch.cuda.synchronize()
                n = listed(prof.key_averages())
            rec = {"listed": n, "engine": eng.counters["quant_matmuls"]
                   - c0["quant_matmuls"], "replays":
                   eng.counters["graph_replays"] - c0["graph_replays"]}
            eng.drain()
            return rec
        for how in ("straight", "idle_gap", "schedule", "straight_again"):
            out[how] = window(how.replace("_again", ""))
        try:
            line = cs.tick_profile(torch, eng, prompts, out["card"],
                                   "count_")
            out["tick_profile"] = {"listed": line[
                "replay_launches_profiled"], "replays": line["graph_replays"]}
        except AssertionError as e:
            out["tick_profile"] = str(e)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
