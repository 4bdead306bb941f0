"""Model losses — counterpart of paddle_tpu/models/losses.py.

`fused_softmax_ce` is the mean cross entropy the GPT loss uses:
loss_i = logsumexp(logits_i) - logits_i[target_i].

- On CUDA it always runs through `ce_fused_train` (kernels/fused_ce.py):
  the one-pass kernel emits the loss and d_logits together, as the
  reference's `pallas_fused` route does. The kernel masks a ragged vocab
  itself, so the reference's cut at V < 512 (pallas_ce.suitable) is not
  carried over.
- On the CPU it runs the reference's jax-level form in f32
  (losses.py:63-67).
"""
from __future__ import annotations

import torch

from ..kernels.fused_ce import ce_fused, ce_fused_train

__all__ = ["fused_softmax_ce"]


def fused_softmax_ce(logits, targets, valid_mask=None, fused=ce_fused):
    """logits [..., V], targets [...] int, valid_mask [...] (bool/0-1)
    selecting the positions that count (None = all) -> the mean loss over
    them, f32. `fused` is the one-pass CE of the CUDA route: the kernel
    wrapper, or ce_fused_ref for the same route without the kernel."""
    lead = logits.shape[:-1]
    V = logits.shape[-1]
    if logits.device.type == "cuda":
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
