"""Model losses — counterpart of paddle_tpu/models/losses.py.

`fused_softmax_ce` is the mean cross entropy the GPT and Llama losses
use: loss_i = logsumexp(logits_i) - logits_i[target_i]. Its route is
resolved as the reference resolves it (losses.py:50-58), from the port's
kernel registry (kernels/registry.py, kernel "ce", class "cuda"):

- CUDA logits, no entry or "pallas": `ce_with_logits`, the two-pass
  pair (kernels 5 and 6 of csrc/fused_ce.cu): the forward saves the row
  lse, the backward rebuilds d_logits from it; a call without a
  gradient launches the forward alone;
- CUDA logits, "pallas_fused": `ce_fused_train`, the one-pass kernel
  that emits d_logits with the loss, for paths that always take the
  gradient;
- CUDA logits, "jax", or a kill switch (the global one or
  PADDLE_TPU_DISABLE_PALLAS_CE), and CPU logits always: the reference's
  jax-level form in f32 (losses.py:63-67).

The kernels mask a ragged vocab themselves, so the reference's cut at
V < 512 (pallas_ce.suitable) is not carried over on either kernel route.
"""
from __future__ import annotations

import os

import torch

from ..kernels import registry
from ..kernels.fused_ce import (ce_bwd, ce_fused, ce_fused_train, ce_fwd,
                                ce_with_logits)

__all__ = ["fused_softmax_ce", "ce_route"]


def _pallas_ce_enabled() -> bool:
    """The CE kernels' gate (reference losses.py:17-30): the global kill
    switch (env PADDLE_TPU_DISABLE_PALLAS or flash_attention.use_pallas),
    then the CE's own env PADDLE_TPU_DISABLE_PALLAS_CE."""
    from ..kernels.flash_attention import _pallas_enabled
    if not _pallas_enabled():
        return False
    return os.environ.get("PADDLE_TPU_DISABLE_PALLAS_CE", "") not in (
        "1", "true", "True")


def ce_route(logits) -> str:
    """The route `fused_softmax_ce` takes for these logits: "pallas",
    "pallas_fused" or "jax"."""
    if logits.device.type != "cuda" or not _pallas_ce_enabled():
        return "jax"
    return registry.winner("ce", backend="cuda") or "pallas"


def fused_softmax_ce(logits, targets, valid_mask=None, fused=ce_fused,
                     fwd=ce_fwd, bwd=ce_bwd):
    """logits [..., V], targets [...] int, valid_mask [...] (bool/0-1)
    selecting the positions that count (None = all) -> the mean loss over
    them, f32. `fwd`/`bwd` are the two-pass route's kernel wrappers and
    `fused` the one-pass route's; ce_fwd_ref, ce_bwd_ref and
    ce_fused_ref give the same routes without the kernels."""
    lead = logits.shape[:-1]
    V = logits.shape[-1]
    route = ce_route(logits)
    if route == "pallas":
        per_pos = ce_with_logits(logits.reshape(-1, V), targets.reshape(-1),
                                 fwd, bwd).reshape(lead)
    elif route == "pallas_fused":
        per_pos = ce_fused_train(logits.reshape(-1, V), targets.reshape(-1),
                                 fused).reshape(lead)
    else:
        lf = logits.float()
        tgt = lf.gather(-1, targets[..., None].long())[..., 0]
        per_pos = torch.logsumexp(lf, -1) - tgt
    if valid_mask is None:
        return per_pos.mean()
    m = valid_mask.float()
    return (per_pos * m).sum() / torch.clamp(m.sum(), min=1.0)
