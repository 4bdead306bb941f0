"""The expert-parallel all-to-all pair of distributed.utils (reference
python/paddle/distributed/utils/, moe/global_scatter op): the port's
counterpart of paddle_tpu/parallel/dist_utils.py `global_scatter` /
`global_gather` (:22-47).

Counts say how many rows each rank exchanges. Equal counts run the real
all-to-all (`collective.all_to_all`: differentiable, on every route);
ragged counts have data-dependent shapes and raise, as the reference's
do: the capacity-routed MoE (parallel/moe.py) is the path for them.
"""
from __future__ import annotations

import numpy as np
import torch

from .collective import all_to_all

__all__ = ["global_scatter", "global_gather"]


def _counts(c):
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    return np.asarray(c).reshape(-1)


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """Rows of x [N, ...] routed rank to rank by counts: the i-th of the
    group's equal row blocks goes to group rank i, and the blocks that
    arrive are stacked in group rank order."""
    lc = _counts(local_count)
    if len(set(lc.tolist())) > 1:
        raise NotImplementedError(
            "global_scatter with ragged per-rank counts has data-"
            "dependent shapes; route through paddle_tpu_torch.parallel.moe "
            "(capacity-routed MoE) instead")
    return all_to_all(x, group, 0, 0)


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """Inverse of global_scatter (the same equal-count contract)."""
    return global_scatter(x, global_count, local_count, group=group)
