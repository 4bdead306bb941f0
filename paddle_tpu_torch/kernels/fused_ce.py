"""One-pass softmax cross-entropy with its gradient, for the train step.

Counterpart of paddle_tpu/kernels/pallas_ce.py's training flavour:
`_ce_fused` (:134, the one-launch loss + d_logits) and `ce_fused_train`
(:272-300, whose VJP is a per-row cotangent scale of the saved
d_logits).

- `ce_fused_ref` is the plain version: loss [T] f32 and d_logits
  (softmax - onehot) [T, V] in the logits' dtype.
- `ce_fused` on a CUDA tensor launches the hand-written kernel of
  csrc/fused_ce.cu (the port of the Pallas `_fused_kernel`) through the
  custom op `paddle_tpu_torch::fused_ce`, after checking its operands,
  and raises on anything the kernel does not take; on a CPU tensor it
  runs `ce_fused_ref`. It never falls back. `launches` counts kernel
  launches.
- `ce_fused_train` is the autograd function: forward returns the loss
  and saves d_logits; backward is `(dx.float() * g[:, None]).to(dx.dtype)`
  (pallas_ce.py:295-296), so d_logits is rounded to its dtype before the
  cotangent scale, as in the reference.

A target outside [0, V) gathers nothing: its loss is the row's
logsumexp and its d_logits row has no -1, as the Pallas kernel's masked
one-hot does.
"""
import ctypes
from typing import Tuple

import torch

from .primitives import logsumexp_finalize

__all__ = ["ce_fused_ref", "ce_fused", "ce_fused_train", "launches"]

launches = 0

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def ce_fused_ref(logits2d, targets) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: [T, V] float, [T] int -> (loss [T] f32,
    d_logits [T, V] in the logits' dtype)."""
    s = logits2d.float()
    V = s.shape[1]
    m = s.amax(-1, keepdim=True)
    lse = logsumexp_finalize(m, torch.exp(s - m).sum(-1, keepdim=True))
    t = targets.long()
    hit = (t >= 0) & (t < V)
    rows = torch.arange(s.shape[0], device=s.device)
    tval = torch.where(hit, s[rows, t.clamp(0, V - 1)], 0.0)
    dx = torch.exp(s - lse)
    dx[rows[hit], t[hit]] -= 1.0
    return lse[:, 0] - tval, dx.to(logits2d.dtype)


@torch.library.custom_op("paddle_tpu_torch::fused_ce", mutates_args=(),
                         device_types="cuda")
def _fused_ce_op(logits2d: torch.Tensor, targets: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    from . import _build
    T, V = logits2d.shape
    loss = torch.empty((T,), dtype=torch.float32, device=logits2d.device)
    dx = torch.empty_like(logits2d)
    fn = getattr(_build.load("fused_ce"),
                 f"fused_ce_{_SUFFIX[logits2d.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(logits2d.device):
        stream = torch.cuda.current_stream(logits2d.device).cuda_stream
        err = fn(logits2d.data_ptr(), targets.data_ptr(), loss.data_ptr(),
                 dx.data_ptr(), T, V, stream)
    if err != 0:
        raise RuntimeError(f"fused_ce kernel launch failed: CUDA error {err} "
                           f"at T={T} V={V}")
    launches += 1
    return loss, dx


def ce_fused(logits2d, targets) -> Tuple[torch.Tensor, torch.Tensor]:
    """loss [T] f32 and unit-cotangent d_logits [T, V] in one pass. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if logits2d.device.type == "cpu":
        return ce_fused_ref(logits2d, targets)
    if logits2d.device.type != "cuda":
        raise ValueError(f"ce_fused: unsupported device {logits2d.device}")
    if logits2d.dtype not in _SUFFIX:
        raise TypeError(f"ce_fused: logits dtype {logits2d.dtype} "
                        "(bfloat16|float32)")
    if (logits2d.dim() != 2 or targets.shape != logits2d.shape[:1]
            or logits2d.shape[0] == 0 or logits2d.shape[1] == 0):
        raise ValueError(f"ce_fused: shapes logits {tuple(logits2d.shape)}, "
                         f"targets {tuple(targets.shape)}")
    if targets.device != logits2d.device or targets.is_floating_point():
        raise ValueError(f"ce_fused: targets {targets.dtype} on "
                         f"{targets.device}, logits on {logits2d.device}")
    if not logits2d.is_contiguous():
        raise ValueError("ce_fused: logits are not contiguous")
    return torch.ops.paddle_tpu_torch.fused_ce(
        logits2d, targets.to(torch.int64).contiguous())


class _CEFusedTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits2d, targets, fused):
        loss, dx = fused(logits2d, targets)
        ctx.save_for_backward(dx)
        return loss

    @staticmethod
    def backward(ctx, g):
        (dx,) = ctx.saved_tensors
        return (dx.float() * g.float()[:, None]).to(dx.dtype), None, None


def ce_fused_train(logits2d, targets, fused=ce_fused):
    """Per-row cross entropy [T, V], [T] -> [T] f32 whose backward costs
    one scale: `fused` (the kernel wrapper; ce_fused_ref for the same
    path without the kernel) emits d_logits with the loss."""
    return _CEFusedTrain.apply(logits2d, targets, fused)
