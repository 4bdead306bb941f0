"""Weight-only int8 rewrite of a serving params tree.

Counterpart of paddle_tpu/quantization/serving.py. Quantization is a
leaf rewrite: every stacked matmul weight in QUANT_LEAVES[family]
becomes an int8 `<name>_q` plus a per-output-channel fp32
`<name>_scale` (stored as abs-max / 127, the ready dequant multiplier),
the fp leaf is dropped, and the tied LM head gets a transposed int8
copy (`head_q` [D, V] + `head_scale` [V]) while `wte` stays fp for the
embedding gather. The cached forward (models/gpt.py) routes every
matmul through kernels/quant_matmul.leaf_matmul, which finds the pair
in the tree.

The tensor-parallel PartitionSpec half of the reference waits for
tensor-parallel serving in the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .int8 import _Q, quantize_weight, quantize_weight_stacked

__all__ = ["QUANT_LEAVES", "HEAD_LEAF", "quantize_serving_params"]

QUANT_LEAVES: Dict[str, tuple] = {
    "gpt": ("qkv_w", "attn_out_w", "mlp_up_w", "mlp_down_w"),
    "llama": ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w"),
}

HEAD_LEAF = "wte"


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _like(arr: np.ndarray, ref):
    """A new leaf in the container type of `ref`: a tensor on ref's
    device when the tree holds tensors, else the numpy array."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(arr).to(ref.device)
    return arr


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return np.asarray(v).nbytes


def quantize_serving_params(params: dict, family: str
                            ) -> Tuple[dict, dict]:
    """Rewrite `params` (numpy arrays or tensors) to weight-only int8.
    Returns (qparams, info); info holds fp_bytes, quant_bytes,
    per_layer, head and quant_leaf_names, as in the reference."""
    leaves = QUANT_LEAVES.get(family)
    if leaves is None:
        raise ValueError(
            f"family {family!r} has no weight-only quant leaf table "
            f"(QUANT_LEAVES covers {sorted(QUANT_LEAVES)})")
    fp_bytes = sum(_nbytes(v) for v in params.values())
    out = dict(params)
    done = []
    for name in leaves:
        if name not in params:
            continue
        w_q, scale = quantize_weight_stacked(_to_numpy(params[name]))
        del out[name]
        out[name + "_q"] = _like(w_q, params[name])
        out[name + "_scale"] = _like(scale / _Q, params[name])
        done.append(name)
    head = 0
    if HEAD_LEAF in params:
        w = _to_numpy(params[HEAD_LEAF]).astype(np.float32).T      # [D, V]
        head_q, head_scale = quantize_weight(w, channel_axis=1)
        out["head_q"] = _like(np.ascontiguousarray(head_q),
                              params[HEAD_LEAF])
        out["head_scale"] = _like(head_scale / _Q, params[HEAD_LEAF])
        head = 1
    quant_bytes = sum(_nbytes(v) for v in out.values())
    info = {"fp_bytes": int(fp_bytes), "quant_bytes": int(quant_bytes),
            "per_layer": len(done), "head": head,
            "quant_leaf_names": tuple(done)}
    return out, info
