#!/usr/bin/env python3
"""Quick check of the MoE and context-parallel GPT paths on the card.

    python3 tools/torch_moe_cp_quick.py

Builds the train kernels (flash attention, the cross entropy, the AdamW
update; nvcc for sm_90a, or the cached libraries), holds the attention
and two-pass CE kernels against their plain versions at chip_smoke.py's
phase 2 shapes (a Ulysses sp2 rank's [8, 1024, 8, 64] and the GPT
logits [8192, 32768] among them) and the AdamW update at phase 2e's
trees (phase 3c's MoE tree and 6b's GPT shards among them), runs chip_smoke.py's phase 3c (the
GPT step with 8 experts, `moe_training`), then 6b's GPT plans alone on
two spawned ranks (ep2, sp2 ring, sp2 Ulysses; sharing the one card
over gloo where there is one), judged by `check_gpt_plans`. Prints each
part's seconds. A short call for iterating on these paths;
chip_smoke.py is the full check. Exits non-zero without a card or when
a build or check fails.
"""
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank(rank, world, workdir, backend):
    """One rank of 6b's GPT plans: joins the group through a file store,
    runs chip_smoke.gpt_sharded_plans, writes workdir/rank<rank>.json."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    cs.bind_to_script()
    cards = torch.cuda.device_count()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % cards))
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.parallel import collective_route, init_parallel_env
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(None)
    torch.cuda.set_device(dev)
    init_parallel_env(backend=backend, init_method=f"file://{workdir}/store",
                      timeout_s=600)
    try:
        out = {"cards": cards, "backend": backend,
               "route": collective_route(None, dev),
               "gpt": cs.gpt_sharded_plans(torch, rank, dev)}
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_cp_quick: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    # the spawned ranks bind themselves to this process (bind_to_script)
    os.environ[cs.SCRIPT_PID_ENV] = str(os.getpid())
    import torch.multiprocessing as mp
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.kernels import _build

    _build.build("flash_attention", "fused_ce", "fused_update")
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    seconds = {}
    t0 = time.perf_counter()
    cs.attention_check(torch, dev)
    cs.ce_pair_check(torch, dev)
    cs.update_check(torch, dev)
    seconds["kernel_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.moe_training(torch, dev, card)
    seconds["gpt_moe_train"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    workdir = tempfile.mkdtemp(prefix="moe_cp_quick_")
    try:
        mp.spawn(_rank, args=(2, workdir, backend), nprocs=2, join=True)
        results = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cs.check_gpt_plans(results, card)
    seconds["gpt_plans_2rank"] = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds}), flush=True)
    print("torch_moe_cp_quick: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
