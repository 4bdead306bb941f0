"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` is the reference; this package carries the
same module names and public functions over to PyTorch, with every
Pallas kernel on a ported path rewritten by hand for NVIDIA Hopper
(sm_90a). It imports torch and numpy only: never jax, and nothing of
paddle_tpu.

Ported so far:
- GPT serving (dense KV slot pool, bucketed prefill, one decode tick for
  all slots) with weight-only int8 through the hand-written
  dequant-matmul kernel (kernels/csrc/quant_matmul.cu);
- the GPT train step on one GPU (models/gpt.py train_step through
  models/facade.py make_train_step, remat "full" or "dots", AdamW),
  with attention through the hand-written flash-attention forward and
  two-pass backward (kernels/csrc/flash_attention.cu) and the loss
  through the one-pass cross entropy (kernels/csrc/fused_ce.cu).
Entry points run on the card unless the caller passes device="cpu".
"""
from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
