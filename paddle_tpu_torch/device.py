"""Device resolution — the port's counterpart of paddle_tpu/framework/place.py
and paddle_tpu/device/__init__.py.

One rule: an entry point runs on the card unless its caller asks for the
CPU. With no argument `resolve_device` returns `cuda:0`; without CUDA it
raises instead of quietly picking the CPU, so a measurement path can
never report CPU numbers as device numbers.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> cuda:0; "cpu" -> cpu; "cuda"/"cuda:N"/torch.device as
    given. Any CUDA request without an available card raises
    RuntimeError."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda|cpu)")
    return dev
