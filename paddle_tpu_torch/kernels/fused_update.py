"""Fused AdamW update, one kernel launch per parameter leaf.

Counterpart of paddle_tpu/kernels/pallas_update.py: `_leaf_update`
(:74, the Pallas kernel over one leaf), `fused_apply_adamw` (:102, the
drop-in for models.gpt.apply_adamw running every leaf through it) and
`fused_update_enabled` (:126, the consult; here :135-145, kill switches
included).

- `leaf_update_ref(p, g, m, v, hp)` is the plain version: the update of
  one leaf evaluated op by op in f32, in `_update_kernel`'s order
  (pallas_update.py:51-59), returning new (p', m', v') with p' in p's
  dtype. `hp` is the f32 [7] vector [lr, b1, b2, eps, wd, bc1, bc2];
  the scalars derived from it (1 - b1, 1 - b2, 1 - lr * wd) are formed
  in f32, as the Pallas kernel forms them.
- `leaf_update(p, g, m, v, hp)` updates p, m and v IN PLACE and returns
  them. On CUDA tensors it launches the hand-written kernel of
  csrc/fused_update.cu through the custom op
  `paddle_tpu_torch::leaf_update`, after checking its operands, and
  raises on anything the kernel does not take; on CPU tensors it runs
  the plain version and copies the result in. `launches["leaf_update"]`
  counts kernel launches.
- `fused_apply_adamw` is the in-place drop-in for models.gpt.
  apply_adamw. It forms `hp` on the leaves' device from
  opt_state["step"] with tensor ops, so a step never waits on the card.
- `fused_update_enabled(device)`: the leaves are on the card and the
  port's registry names "pallas" for "fused_update" (no entry: the plain
  per-leaf update stays the default and the parity oracle); a kill
  switch (the global one, PADDLE_TPU_DISABLE_PALLAS_UPDATE) turns it
  off.

The kernel rounds every operation on its own (no fused multiply-add),
so on the same hp it reproduces `leaf_update_ref` exactly wherever the
device's division and square root are correctly rounded, as the card's
are without --use_fast_math.
"""
import ctypes
import os

import torch

from . import registry

__all__ = ["leaf_update_ref", "leaf_update", "fused_apply_adamw",
           "fused_update_enabled", "launches"]

launches = {"leaf_update": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def leaf_update_ref(p, g, m, v, hp):
    """AdamW on one leaf, plain: -> (p' in p.dtype, m' f32, v' f32)."""
    lr, b1, b2, eps, wd, bc1, bc2 = hp.float().unbind(0)
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * (gf * gf)
    den = torch.sqrt(v_new / bc2) + eps
    p_new = p.float() * (1 - lr * wd) - lr * (m_new / bc1) / den
    return p_new.to(p.dtype), m_new, v_new


@torch.library.custom_op("paddle_tpu_torch::leaf_update",
                         mutates_args=("p", "m", "v"), device_types="cuda")
def _leaf_update_op(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, hp: torch.Tensor) -> None:
    from . import _build
    fn = getattr(_build.load("fused_update"),
                 f"leaf_update_{_SUFFIX[p.dtype]}_{_SUFFIX[g.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vec = int(all(t.data_ptr() % 16 == 0 for t in (p, g, m, v)))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 hp.data_ptr(), p.numel(), vec, stream)
    if err != 0:
        raise RuntimeError(f"leaf_update kernel launch failed: CUDA error "
                           f"{err} at n={p.numel()}")
    launches["leaf_update"] += 1


def _check_operands(p, g, m, v, hp):
    for name, t, dtypes in (("p", p, _SUFFIX), ("g", g, _SUFFIX),
                            ("m", m, (torch.float32,)),
                            ("v", v, (torch.float32,)),
                            ("hp", hp, (torch.float32,))):
        if t.dtype not in dtypes:
            raise TypeError(f"leaf_update: {name} dtype {t.dtype} "
                            f"({'|'.join(str(d) for d in dtypes)})")
        if t.device != p.device:
            raise ValueError(f"leaf_update: {name} on {t.device}, p on "
                             f"{p.device}")
        if not t.is_contiguous():
            raise ValueError(f"leaf_update: {name} is not contiguous")
    if g.shape != p.shape or m.shape != p.shape or v.shape != p.shape:
        raise ValueError(f"leaf_update: shapes p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                         f"{tuple(v.shape)}")
    if hp.shape != (7,) or p.numel() == 0:
        raise ValueError(f"leaf_update: hp {tuple(hp.shape)} (want (7,)), "
                         f"{p.numel()} elements")


def leaf_update(p, g, m, v, hp):
    """AdamW on one leaf, IN PLACE on p, m and v; returns (p, m, v). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if p.device.type == "cpu":
        for t, new in zip((p, m, v), leaf_update_ref(p, g, m, v, hp)):
            t.copy_(new)
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"leaf_update: unsupported device {p.device}")
    _check_operands(p, g, m, v, hp)
    torch.ops.paddle_tpu_torch.leaf_update(p, g, m, v, hp)
    return p, m, v


@torch.no_grad()
def fused_apply_adamw(grads, params, opt_state, lr, beta1=0.9, beta2=0.95,
                      eps=1e-8, weight_decay=0.1):
    """models.gpt.apply_adamw with every leaf through `leaf_update` (the
    kernel), IN PLACE; returns (params, opt_state)."""
    step = opt_state["step"].add_(1.0)
    one = torch.ones_like(step)
    hp = torch.stack([one * lr, one * beta1, one * beta2, one * eps,
                      one * weight_decay, 1.0 - beta1 ** step,
                      1.0 - beta2 ** step])
    for k, p in params.items():
        leaf_update(p, grads[k], opt_state["m"][k], opt_state["v"][k], hp)
    return params, opt_state


def fused_update_enabled(device) -> bool:
    """The gpt.apply_adamw consult (reference pallas_update.py:127-140):
    leaves on the card, no kill switch (the global one, or
    PADDLE_TPU_DISABLE_PALLAS_UPDATE), and the registry's "fused_update"
    winner naming "pallas"."""
    from .flash_attention import _pallas_enabled
    if not _pallas_enabled() or os.environ.get(
            "PADDLE_TPU_DISABLE_PALLAS_UPDATE", "") in ("1", "true", "True"):
        return False
    return (torch.device(device).type == "cuda"
            and registry.winner("fused_update", backend="cuda") == "pallas")
