#!/usr/bin/env python3
"""Quick check of the serving fleet on the card (ROADMAP A7 part 3).

    python3 tools/torch_fleet_quick.py [--tp-preempt]

Builds the int8 dequant-matmul and the threefry kernels (nvcc for
sm_90a), then runs chip_smoke.py's phase 5g alone (`gpt_fleet`) on phase
5's GPT weights (FULL, seed 0, drawn on the host, one int8 rewrite for
every replica): the fleet scenarios of tools/chaos_serving.py (replica
death, live migration on dense, paged and K = 4 graphed replicas,
migrate_raise, autoscale, prefill/decode roles, tenant flood, the
brownout ladder, host spill flood, a SIGKILLed child replayed from its
journal), a router tick's ms serial against concurrent, and every run's
kernel launches against its passes and draws. With `--tp-preempt` it
runs phase 5e (b) instead: 5c's single-card paged engine on its
TinyLlama-width weights for the reference streams, then the two tp ranks
with only the preempt guard's drill. Prints each part's seconds. A short
call for iterating on the phases; chip_smoke.py is the full check. Exits
non-zero without a card or when a build or check fails.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tp_preempt(torch, cs, qm, dev, card):
    """5e (b) alone: the reference streams from 5c's paged engine, then
    both ranks' drills and `tp_preempt_check`."""
    import json
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.quantization import serving as qs
    cfg, params = cs.llama_host_params()
    per_pass = sum(cs.pass_calls(cs.LLAMA_LEAF_KN, cfg.num_layers).values())
    with cs.quantize_once():
        eng = ServingEngine(params, cfg, family="llama", num_slots=8,
                            max_len=2048, max_top_k=50, seed=0, quant="int8",
                            **cs.PAGED)
        prompts = cs.paged_prompts(cfg.vocab_size)
        streams, _, _ = cs.run_engine(torch, qm, eng, prompts, "paged", card,
                                      per_pass, per_pass, profile=False,
                                      new_tokens=cs.TP_NEW_TOKENS)
        del eng
        tree = qs.quantize_serving_params(params, "llama")
    workdir = tempfile.mkdtemp(prefix="torch_fleet_quick_")
    try:
        torch.save(tree, os.path.join(workdir, "int8.pt"))
        mp.spawn(cs._tp_serving_rank, args=(cs.TP, workdir, ()),
                 nprocs=cs.TP, join=True)
        ranks = []
        for r in range(cs.TP):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches, draws, summary = cs.tp_preempt_check(
        torch, qm, cfg, dev, ranks, {"paged": {"streams": streams}}, tree)
    print(json.dumps({"phase": "llama_tp2_preempt", "card": card,
                      **summary}), flush=True)
    return launches, draws


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_fleet_quick: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.environ.setdefault("CHIP_SMOKE_PID", str(os.getpid()))
    import chip_smoke as cs
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm

    t_start = time.perf_counter()
    _build.build("quant_matmul", "threefry")
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    seconds = {"build": time.perf_counter() - t_start}
    try:
        if "--tp-preempt" in sys.argv[1:]:
            t0 = time.perf_counter()
            launches, draws = tp_preempt(torch, cs, qm, dev, card)
            seconds["5e_b"] = time.perf_counter() - t0
            out = {"launches": launches, "draws": draws}
        else:
            t0 = time.perf_counter()
            cfg, params = cs.gpt_host_params()
            seconds["host_params"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            with cs.quantize_once():
                cs.DRAWS.update(launches=0, captured=0, replayed=0)
                launches, replays = cs.gpt_fleet(torch, qm, dev, card, cfg,
                                                 params)
            seconds["5g"] = time.perf_counter() - t0
            if not cs.DRAWS["launches"] + cs.DRAWS["captured"]:
                raise AssertionError(f"no threefry kernel launch in 5g: "
                                     f"{cs.DRAWS}")
            out = {"launches": launches, **replays, "draws": dict(cs.DRAWS)}
    finally:
        cs.stop_descendants(keep=(cs.RESOURCE_TRACKER,))
    seconds["total"] = time.perf_counter() - t_start
    print({**out, "seconds": seconds}, flush=True)
    print("torch_fleet_quick: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
