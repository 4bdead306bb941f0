"""Per-output-channel int8 weight quantizer (numpy).

Counterpart of paddle_tpu/quantization/int8.py (`_Q`, `quantize_weight`,
`quantize_weight_stacked`), kept in numpy on purpose: the int8 bytes and
the scales must be bit-equal to the reference quantizer's, and numpy's
`np.round` (half to even) is what the reference uses. Reference analog:
the channel_wise_abs_max weight path of
python/paddle/static/quantization/post_training_quantization.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["quantize_weight", "quantize_weight_stacked"]

_Q = 127.0


def quantize_weight(w: np.ndarray, channel_axis: Optional[int] = None):
    """fp weight -> (int8 weight, fp32 abs-max scale). Per channel over
    `channel_axis`, else per tensor."""
    w = np.asarray(w, np.float32)
    if channel_axis is None:
        scale = np.maximum(np.abs(w).max(), 1e-8).astype(np.float32)
        return (np.clip(np.round(w / scale * _Q), -_Q, _Q).astype(np.int8),
                scale)
    axes = tuple(i for i in range(w.ndim) if i != channel_axis)
    scale = np.maximum(np.abs(w).max(axis=axes), 1e-8).astype(np.float32)
    shape = [1] * w.ndim
    shape[channel_axis] = -1
    return (np.clip(np.round(w / scale.reshape(shape) * _Q), -_Q, _Q)
            .astype(np.int8), scale)


def quantize_weight_stacked(w: np.ndarray):
    """Stacked fp weight [L, ..., N] -> (int8 [L, ..., N], fp32 scales
    [L, N]): per-output-channel abs-max over every reduction axis,
    vectorized over the leading layer axis."""
    w = np.asarray(w, np.float32)
    if w.ndim < 3:
        raise ValueError(f"stacked weight must be [L, ..., N] with at "
                         f"least one reduction axis; got shape {w.shape}")
    red = tuple(range(1, w.ndim - 1))
    scale = np.maximum(np.abs(w).max(axis=red), 1e-8).astype(np.float32)
    scale_b = scale.reshape(
        (w.shape[0],) + (1,) * (w.ndim - 2) + (w.shape[-1],))
    w_q = np.clip(np.round(w / scale_b * _Q), -_Q, _Q).astype(np.int8)
    return w_q, scale
