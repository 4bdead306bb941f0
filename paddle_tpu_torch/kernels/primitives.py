"""Kernel primitives of the port's plain-PyTorch side.

Counterpart of paddle_tpu/kernels/primitives.py, copied (the port imports
nothing of the reference): the online-softmax log-normalizer with its
1e-30 floor, which the plain cross entropy finalizes with. The rest of
the reference's primitives serve its Pallas kernels; their counterparts
live in the CUDA sources (csrc/flash_attention.cu, csrc/fused_ce.cu:
NEG_INF = -1e30 for masked scores, the causal tile skip, the same 1e-30
floors).
"""
from __future__ import annotations

import torch

__all__ = ["logsumexp_finalize"]


def logsumexp_finalize(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Log-normalizer from streamed (m, l); the 1e-30 floor keeps rows
    with nothing summed finite."""
    return m + torch.log(torch.clamp(l, min=1e-30))
