"""Softmax cross-entropy over a large vocab: the two-pass pair (the
reference's default route) and the one-pass CE+grad (its training-only
route).

Counterpart of paddle_tpu/kernels/pallas_ce.py:
- `_ce_fwd` (:172, per-row loss and lse) and `_ce_bwd` (:205, d_logits
  from the saved lse), joined by the `ce_with_logits` custom VJP
  (:246-269);
- `_ce_fused` (:134, loss and d_logits in one launch) and
  `ce_fused_train` (:272-300, whose VJP is a per-row cotangent scale of
  the saved d_logits).

Plain versions: `ce_fwd_ref` -> (loss [T] f32, lse [T] f32),
`ce_bwd_ref` -> dx = ((softmax - onehot) * g) rounded once to the
logits' dtype, `ce_fused_ref` -> (loss, unit-cotangent d_logits).

Wrappers: `ce_fwd`, `ce_bwd` and `ce_fused` on CUDA tensors launch the
hand-written kernels of csrc/fused_ce.cu through the custom ops
`paddle_tpu_torch::ce_fwd`, `::ce_bwd` and `::fused_ce`, after checking
their operands, and raise on anything the kernels do not take; on CPU
tensors they run the plain versions. They never fall back.
`launches[name]` counts kernel launches.

Autograd:
- `ce_with_logits` saves (logits, targets, lse) in the forward and
  launches `ce_bwd` with `g.float()` in the backward; under
  `torch.no_grad()` only `ce_fwd` runs;
- `ce_fused_train` saves d_logits; its backward is
  `(dx.float() * g[:, None]).to(dx.dtype)` (pallas_ce.py:295-296), so
  d_logits is rounded before the cotangent scale and again after it,
  where the two-pass backward rounds `(p - onehot) * g` once
  (pallas_ce.py:77).

A target outside [0, V) gathers nothing: its loss is the row's
logsumexp and its d_logits row has no -1, as the Pallas kernels' masked
one-hot does.
"""
import ctypes
from typing import Tuple

import torch

from .primitives import logsumexp_finalize

__all__ = ["ce_fwd_ref", "ce_bwd_ref", "ce_fused_ref", "ce_fwd", "ce_bwd",
           "ce_fused", "ce_with_logits", "ce_fused_train", "launches"]

launches = {"ce_fwd": 0, "ce_bwd": 0, "fused_ce": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


# ------------------------------------------------------------ plain half
def _lse_and_target(s, targets):
    """Row lse [T, 1] of f32 logits s, the rows whose target is in range,
    and their target logits (0 elsewhere)."""
    V = s.shape[1]
    m = s.amax(-1, keepdim=True)
    lse = logsumexp_finalize(m, torch.exp(s - m).sum(-1, keepdim=True))
    t = targets.long()
    hit = (t >= 0) & (t < V)
    rows = torch.arange(s.shape[0], device=s.device)
    tval = torch.where(hit, s[rows, t.clamp(0, V - 1)], 0.0)
    return lse, hit, tval


def ce_fwd_ref(logits2d, targets) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward: [T, V] float, [T] int ->
    (loss [T] f32, lse [T] f32)."""
    lse, _, tval = _lse_and_target(logits2d.float(), targets)
    return lse[:, 0] - tval, lse[:, 0]


def ce_bwd_ref(logits2d, targets, lse, g) -> torch.Tensor:
    """The plain version of the backward: dx = (exp(s - lse) - onehot)
    * g in f32, rounded once to the logits' dtype."""
    s = logits2d.float()
    V = s.shape[1]
    t = targets.long()
    p = torch.exp(s - lse.float()[:, None])
    hit = (t >= 0) & (t < V)
    rows = torch.arange(s.shape[0], device=s.device)
    p[rows[hit], t[hit]] -= 1.0
    return (p * g.float()[:, None]).to(logits2d.dtype)


def ce_fused_ref(logits2d, targets) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the one-pass kernel: [T, V] float, [T] int ->
    (loss [T] f32, d_logits [T, V] in the logits' dtype)."""
    s = logits2d.float()
    lse, hit, tval = _lse_and_target(s, targets)
    t = targets.long()
    rows = torch.arange(s.shape[0], device=s.device)
    dx = torch.exp(s - lse)
    dx[rows[hit], t[hit]] -= 1.0
    return lse[:, 0] - tval, dx.to(logits2d.dtype)


# ----------------------------------------------------------- kernel half
def _launch(kernel: str, dtype, args, T: int, V: int, device):
    from . import _build
    fn = getattr(_build.load("fused_ce"), f"{kernel}_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * len(args) + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, T, V, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} "
                           f"at T={T} V={V}")
    launches[kernel] += 1


@torch.library.custom_op("paddle_tpu_torch::fused_ce", mutates_args=(),
                         device_types="cuda")
def _fused_ce_op(logits2d: torch.Tensor, targets: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    T, V = logits2d.shape
    loss = torch.empty((T,), dtype=torch.float32, device=logits2d.device)
    dx = torch.empty_like(logits2d)
    _launch("fused_ce", logits2d.dtype,
            (logits2d.data_ptr(), targets.data_ptr(), loss.data_ptr(),
             dx.data_ptr()), T, V, logits2d.device)
    return loss, dx


@torch.library.custom_op("paddle_tpu_torch::ce_fwd", mutates_args=(),
                         device_types="cuda")
def _ce_fwd_op(logits2d: torch.Tensor, targets: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    T, V = logits2d.shape
    loss = torch.empty((T,), dtype=torch.float32, device=logits2d.device)
    lse = torch.empty((T,), dtype=torch.float32, device=logits2d.device)
    _launch("ce_fwd", logits2d.dtype,
            (logits2d.data_ptr(), targets.data_ptr(), loss.data_ptr(),
             lse.data_ptr()), T, V, logits2d.device)
    return loss, lse


@torch.library.custom_op("paddle_tpu_torch::ce_bwd", mutates_args=(),
                         device_types="cuda")
def _ce_bwd_op(logits2d: torch.Tensor, targets: torch.Tensor,
               lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    T, V = logits2d.shape
    dx = torch.empty_like(logits2d)
    _launch("ce_bwd", logits2d.dtype,
            (logits2d.data_ptr(), targets.data_ptr(), lse.data_ptr(),
             g.data_ptr(), dx.data_ptr()), T, V, logits2d.device)
    return dx


def _on_card(name, logits2d, targets, *rows) -> bool:
    """False for CPU logits (the plain version runs); for CUDA logits,
    checks every operand the kernel takes and raises on the rest."""
    if logits2d.device.type == "cpu":
        return False
    if logits2d.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {logits2d.device}")
    if logits2d.dtype not in _SUFFIX:
        raise TypeError(f"{name}: logits dtype {logits2d.dtype} "
                        "(bfloat16|float32)")
    if (logits2d.dim() != 2 or targets.shape != logits2d.shape[:1]
            or logits2d.shape[0] == 0 or logits2d.shape[1] == 0):
        raise ValueError(f"{name}: shapes logits {tuple(logits2d.shape)}, "
                         f"targets {tuple(targets.shape)}")
    if targets.device != logits2d.device or targets.is_floating_point():
        raise ValueError(f"{name}: targets {targets.dtype} on "
                         f"{targets.device}, logits on {logits2d.device}")
    if not logits2d.is_contiguous():
        raise ValueError(f"{name}: logits are not contiguous")
    for r in rows:
        if (r.shape != logits2d.shape[:1] or r.dtype != torch.float32
                or r.device != logits2d.device):
            raise ValueError(f"{name}: row operand {tuple(r.shape)} "
                             f"{r.dtype} on {r.device}, want "
                             f"({logits2d.shape[0]},) float32 on "
                             f"{logits2d.device}")
    return True


def ce_fused(logits2d, targets) -> Tuple[torch.Tensor, torch.Tensor]:
    """loss [T] f32 and unit-cotangent d_logits [T, V] in one pass. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not _on_card("ce_fused", logits2d, targets):
        return ce_fused_ref(logits2d, targets)
    return torch.ops.paddle_tpu_torch.fused_ce(
        logits2d, targets.to(torch.int64).contiguous())


def ce_fwd(logits2d, targets) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss [T] f32, lse [T] f32), one read of the logits. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if not _on_card("ce_fwd", logits2d, targets):
        return ce_fwd_ref(logits2d, targets)
    return torch.ops.paddle_tpu_torch.ce_fwd(
        logits2d, targets.to(torch.int64).contiguous())


def ce_bwd(logits2d, targets, lse, g) -> torch.Tensor:
    """d_logits [T, V] in the logits' dtype from the saved lse [T] and
    the cotangent g [T] (both f32). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not _on_card("ce_bwd", logits2d, targets, lse, g):
        return ce_bwd_ref(logits2d, targets, lse, g)
    return torch.ops.paddle_tpu_torch.ce_bwd(
        logits2d, targets.to(torch.int64).contiguous(), lse.contiguous(),
        g.contiguous())


# --------------------------------------------------------------- autograd
class _CEWithLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits2d, targets, fwd, bwd):
        loss, lse = fwd(logits2d, targets)
        ctx.save_for_backward(logits2d, targets, lse)
        ctx.bwd = bwd
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2d, targets, lse = ctx.saved_tensors
        return ctx.bwd(logits2d, targets, lse, g.float()), None, None, None


def ce_with_logits(logits2d, targets, fwd=ce_fwd, bwd=ce_bwd):
    """Per-row cross entropy [T, V], [T] -> [T] f32: `fwd` (the kernel
    wrapper; ce_fwd_ref for the same path without the kernel) saves the
    lse, and the backward runs `bwd` (ce_bwd or ce_bwd_ref) from it."""
    return _CEWithLogits.apply(logits2d, targets, fwd, bwd)


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
    path without the kernel) emits d_logits with the loss. A call that
    takes no gradient pays for the discarded d_logits all the same."""
    return _CEFusedTrain.apply(logits2d, targets, fused)
