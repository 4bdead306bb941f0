#!/usr/bin/env python3
"""Quick check of the planner-driven sharded train step on the card.

    python3 tools/torch_sharded_quick.py

Builds the train kernels (flash attention, the cross entropy, the AdamW
update; nvcc for sm_90a, or the cached libraries), holds them against
their plain versions at chip_smoke.py's phase 2 shapes (those of phase
6b's ranks among them), runs the unsharded
Llama step at chip_smoke.py's phase 4 configuration (TinyLlama widths,
batch 4 x 2048, full remat, the fused update forced) for 5 steps from
phase 4's starting state, which stands in for phase 4's trajectory,
launches a step and p50, then runs chip_smoke.py's phase 6: 6a, the
sharded step on one rank, and 6b, its plans on two ranks (tp2, fsdp2
and the pipelined pp2; sharing the one card over gloo where there is
one) with 6c (b), fsdp2's snapshot restored onto pp2; then 6c (a), the
full-depth state saved asynchronously and resumed, and the resilience
drill. Prints the free disk of the temporary directory and each part's
seconds. A short call for
iterating on the sharded step; chip_smoke.py is the full check. Exits
non-zero without a card or when a build or check fails.
"""
import os
import shutil
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def phase4_standin(torch, cs, dev):
    """A stand-in for chip_smoke.py's phase 4, what phase 6 reads of it:
    the unsharded Llama step at phase 4's configuration (TinyLlama
    widths, batch 4 x 2048, full remat, the fused update forced) for 5
    steps from phase 4's starting state: the trajectory, the launches a
    step, the p50 of steps 2-5, the peak and the MFU."""
    from paddle_tpu_torch.cost_model import train_flops_per_token
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.models.gpt import init_opt_state
    cfg = llama.LlamaConfig(**cs.LLAMA, remat=True)
    params = llama.init_llama_params(cfg, seed=0)
    opt = init_opt_state(params)
    tokens = cs.train_tokens(torch, dev, cfg, cs.LLAMA_BATCH, cs.LLAMA_SEQ,
                             3)
    step = make_train_step(llama.train_step, cfg=cfg, **cs.ADAMW)
    with cs.forced_registry(fused_update="pallas"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs.zero_launch_counts()
        traj, ms = cs.timed_losses(torch, step, params, opt, tokens, 5)
        launches = cs.launch_counts()
    p50 = statistics.median(ms[1:])
    fpt = train_flops_per_token(sum(p.numel() for p in params.values()),
                                cfg.num_layers, cfg.hidden_size,
                                cs.LLAMA_SEQ)
    p4 = {"trajectory": traj, "train": {
        "launches_per_step": {k: v // 5 for k, v in launches.items()},
        "step_ms_p50": p50,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "mfu": fpt * cs.LLAMA_BATCH * cs.LLAMA_SEQ / (p50 / 1e3)
        / cs.PEAK_BF16_FLOPS}}
    del step, params, opt, tokens
    torch.cuda.empty_cache()
    return p4


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_sharded_quick: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.kernels import _build

    _build.build("flash_attention", "fused_ce", "fused_update")
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    cs.attention_check(torch, dev)
    cs.ce_pair_check(torch, dev)
    cs.update_check(torch, dev)
    p4 = phase4_standin(torch, cs, dev)
    print({"unsharded": p4}, flush=True)
    tmp = tempfile.gettempdir()
    print({"tmp": tmp, "free_bytes": shutil.disk_usage(tmp).free,
           "cwd_free_bytes": shutil.disk_usage(HERE).free}, flush=True)
    seconds = {}
    t0 = time.perf_counter()
    cs.sharded_one_rank(torch, dev, card, p4)
    seconds["6a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.sharded_two_ranks(torch, card)
    seconds["6b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.checkpoint_resume(torch, dev, card, p4)
    seconds["6c_a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.resilience_drill(torch, dev, card)
    seconds["drill"] = time.perf_counter() - t0
    print({"seconds": seconds}, flush=True)
    print("torch_sharded_quick: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
