"""Cost accounting — counterpart of paddle_tpu/cost_model.py.

`train_flops_per_token` is the one formula the train step's MFU is
priced with (chip_smoke.py), copied from the reference so the port's MFU
and the reference's stay comparable.
"""
from __future__ import annotations

__all__ = ["train_flops_per_token"]


def train_flops_per_token(n_params: int, num_layers: int,
                          hidden_size: int, seq: int) -> float:
    """6N matmul FLOPs per token (forward + backward) plus the attention
    score/context matmul term."""
    return 6.0 * n_params + 12.0 * num_layers * hidden_size * seq
