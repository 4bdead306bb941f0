"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` is the reference; this package carries the
same module names and public functions over to PyTorch, with every
Pallas kernel on a ported path rewritten by hand for NVIDIA Hopper
(sm_90a). It imports torch and numpy only: never jax, and nothing of
paddle_tpu.

Ported so far (ROADMAP.md A1-A6d): GPT and Llama serving with weight-only
int8 through the hand-written dequant-matmul kernel, the paged KV pool,
speculative and multi-tick decode, the host KV tier, threefry sampling and
tensor-parallel engines; the GPT and Llama train steps through the
hand-written flash-attention, cross-entropy and AdamW kernels; the
planner-driven dp×fsdp×tp(×pp) step, sharded checkpoints, the resilient
step and the elastic controller with its launcher.
Entry points run on the card unless the caller passes device="cpu".
"""
from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
