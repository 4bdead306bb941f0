"""Distributed environment bootstrap — the port's counterpart of
paddle_tpu/parallel/env.py (`init_parallel_env` :23, `get_rank` :52,
`get_world_size` :58, `is_initialized` :64, `device_count` :68,
`local_device_count` :72, `ParallelEnv` :76).

The reference is single-controller: JAX drives every local chip from one
process, so its "rank" is the host and per-chip parallelism is a mesh.
On torch one process drives one rank, and a rank holds one device: a job
on N cards runs N processes (`torchrun --nproc_per_node=N`), and
`init_parallel_env` joins this process to them through
`torch.distributed.init_process_group`. It reads the reference's
launcher variables (PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ID,
PADDLE_MASTER) first and torchrun's (WORLD_SIZE, RANK, MASTER_ADDR,
MASTER_PORT) after them, as the reference does; LOCAL_RANK picks the
rank's card (device.resolve_device). The backend is NCCL where CUDA is
available and gloo otherwise, unless the caller names one.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "device_count", "local_device_count",
           "ParallelEnv"]


def _env_int(names, default: int) -> int:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return default


def init_parallel_env(strategy=None, backend: Optional[str] = None,
                      init_method: Optional[str] = None,
                      world_size: Optional[int] = None,
                      timeout_s: Optional[float] = None):
    """Join the process group of this job; a no-op once joined. The rank
    comes from the launch environment, and so does `world_size` unless
    given (1 process when it sets none: a caller asks for a world of one
    under a launcher with world_size=1); `init_method` defaults to
    tcp://MASTER_ADDR:MASTER_PORT, or an in-process store for a world of
    one; `backend` to "nccl" with CUDA and "gloo" without. On CUDA the
    rank's card (LOCAL_RANK, else the current device) becomes the
    current device first, as NCCL needs."""
    if dist.is_initialized():
        return
    world = world_size if world_size is not None else _env_int(
        ("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 1)
    rank = _env_int(("PADDLE_TRAINER_ID", "RANK"), 0)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        from ..device import resolve_device
        torch.cuda.set_device(resolve_device(None))
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if init_method is None and world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
        return
    if init_method is None:
        master = os.environ.get("PADDLE_MASTER") or (
            os.environ.get("MASTER_ADDR", "127.0.0.1") + ":"
            + os.environ.get("MASTER_PORT", "12355"))
        init_method = f"tcp://{master}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)


def get_rank(group=None) -> int:
    """This process's rank in `group` (the world by default); 0 before
    the process group exists."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    """The ranks in `group` (the world by default); 1 before the process
    group exists."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_initialized() -> bool:
    return dist.is_initialized()


def device_count() -> int:
    """Devices in the job: one per rank (the reference's
    jax.device_count())."""
    return get_world_size()


def local_device_count() -> int:
    """Cards this host shows (1 on a host without CUDA, its CPU)."""
    return torch.cuda.device_count() or 1


class ParallelEnv:
    """reference: python/paddle/distributed/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return int(os.environ.get("LOCAL_RANK", "0") or 0)

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else ["127.0.0.1:6170"]
