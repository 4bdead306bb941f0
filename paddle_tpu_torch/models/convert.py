"""Carry a params tree across from the JAX package.

`params_from_jax` takes a dict of numpy arrays — what `np.asarray` makes
of paddle_tpu's `init_gpt_params` or `quantize_serving_params` output —
and returns the port's tensors, by leaf name, unchanged in layout and
dtype; `opt_state_from_jax` does the same for `init_opt_state`'s
{"m", "v", "step"} tree, so both packages can train from one state.
The port never imports jax: the caller converts to numpy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "opt_state_from_jax"]


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(np_params: Dict[str, np.ndarray], device=None
                    ) -> Dict[str, torch.Tensor]:
    """{leaf: numpy array} -> {leaf: tensor on `device`} (default: the
    card), same shapes and dtypes."""
    from ..device import resolve_device
    dev = resolve_device(device)
    return {name: _tensor(v).to(dev) for name, v in np_params.items()}


def opt_state_from_jax(np_opt, device=None) -> Dict:
    """{"m": {leaf: array}, "v": {...}, "step": scalar} -> the same tree
    of tensors on `device` (default: the card), as models/gpt.py's
    init_opt_state lays it out."""
    from ..device import resolve_device
    dev = resolve_device(device)
    return {"m": params_from_jax(np_opt["m"], dev),
            "v": params_from_jax(np_opt["v"], dev),
            "step": _tensor(np_opt["step"]).to(dev, torch.float32)}
