#!/usr/bin/env python3
"""What torch.distributed offers two ranks that share one card.

    python3 tools/torch_gloo_cuda_probe.py

Spawns two ranks over gloo on card 0 (NCCL refuses two ranks on one
device) and one rank over NCCL, and prints one JSON line a rank: the
Python, torch and CUDA versions, a DeviceMesh of axes (dp, fsdp, tp)
with each axis's group size and backend, this rank's coordinate, a
small all-reduce's result, the seconds of two all-reduces of 256 MB of
f32 on the card, and whether the backend's own all_gather and
reduce_scatter accept CUDA tensors. chip_smoke.py's phase 6b reaches
each other rank through gloo's all-reduce (parallel/collective.py's
"gloo_cuda_via_all_reduce" route); this measures that route's rate.
Exits non-zero without a card.
"""
import json
import os
import subprocess
import sys
import tempfile
import time


def _rank(rank, world, path, backend):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{path}",
                            rank=rank, world_size=world)
    try:
        out = {"rank": rank, "backend": backend}
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(1, 1, world),
                          mesh_dim_names=("dp", "fsdp", "tp"))
        out["mesh"] = [(n, dist.get_world_size(mesh.get_group(n)),
                        str(dist.get_backend(mesh.get_group(n))))
                       for n in ("dp", "fsdp", "tp")]
        out["coordinate"] = mesh.get_coordinate()
        x = torch.full((1 << 20,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        out["all_reduce_small"] = float(x[0])
        big = torch.ones((64 << 20,), device="cuda")     # 256 MB of f32
        out["all_reduce_256MB_s"] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(big)
            torch.cuda.synchronize()
            out["all_reduce_256MB_s"].append(time.perf_counter() - t0)
        one = torch.ones(4, device="cuda")
        for name, call in (
                ("all_gather", lambda: dist.all_gather(
                    [torch.empty_like(one) for _ in range(world)], one)),
                ("reduce_scatter", lambda: dist.reduce_scatter(
                    torch.empty_like(one), [one.clone()
                                            for _ in range(world)]))):
            try:
                call()
                torch.cuda.synchronize()
                out[name] = "ok"
            except RuntimeError as e:
                out[name] = str(e)[:160]
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def main():
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.device_count(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for world, backend in ((2, "gloo"), (1, "nccl")):
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank, args=(world, os.path.join(tmp, "store"),
                                  backend), nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
