"""GPT — the cached (serving) half of the flagship model family.

Counterpart of paddle_tpu/models/gpt.py: `GPTConfig`, `init_gpt_params`
(the same leaf names and stacked [L, ...] shapes, so a JAX params tree
converts one to one — models/convert.py), `_ln`, `init_kv_cache`,
`_cached_attention`, `gpt_forward_cached` and `greedy_generate`.

The reference scans the stacked leaves with lax.scan; here a Python
loop over the layer axis indexes them (`leaf[l]` is a view, so nothing
is copied). The KV cache {"k","v": [L, B, max_len, H, hd]} is written in
place (kernels/decode_attention.write_kv).

Numerics kept from the reference: LayerNorm statistics in f32 with eps
1e-5, cast back to the activation dtype; GELU in its tanh form (the
default of jax.nn.gelu); the fp head is einsum("bsd,vd->bsv") in the
activation dtype; the int8 head is the fused dequant-matmul.

The training half (train_step, flash attention, fused CE, AdamW) is a
later slice.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.decode_attention import cached_attention, write_kv
from ..kernels.quant_matmul import leaf_matmul, quant_matmul

__all__ = ["GPTConfig", "init_gpt_params", "init_kv_cache",
           "gpt_forward_cached", "greedy_generate"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: Optional[int] = None          # default 4*hidden
    max_seq_len: int = 1024
    use_bias: bool = True
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size
        assert self.hidden_size % self.num_heads == 0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


_BLOCK_KEYS_DENSE = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
                     "qkv_w", "qkv_b", "attn_out_w", "attn_out_b",
                     "mlp_up_w", "mlp_up_b", "mlp_down_w", "mlp_down_b")


def init_gpt_params(cfg: GPTConfig, seed: int = 0, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Random parameters drawn with numpy from `seed` (std 0.02, wpe
    0.01, output projections scaled by 1/sqrt(2L), as the reference
    initializes), on `device` (default: the card)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, Fh, L, V = (cfg.hidden_size, cfg.ffn_hidden, cfg.num_layers,
                   cfg.vocab_size)
    std = 0.02

    def norm(shape, scale=std):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev, cfg.param_dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=cfg.param_dtype, device=dev)

    return {
        "wte": norm((V, D)),
        "wpe": norm((cfg.max_seq_len, D), 0.01),
        "ln_f_scale": const((D,), 1.0),
        "ln_f_bias": const((D,), 0.0),
        "ln1_scale": const((L, D), 1.0),
        "ln1_bias": const((L, D), 0.0),
        "ln2_scale": const((L, D), 1.0),
        "ln2_bias": const((L, D), 0.0),
        "qkv_w": norm((L, D, 3 * D)),
        "qkv_b": const((L, 3 * D), 0.0),
        "attn_out_w": norm((L, D, D), std / math.sqrt(2 * L)),
        "attn_out_b": const((L, D), 0.0),
        "mlp_up_w": norm((L, D, Fh)),
        "mlp_up_b": const((L, Fh), 0.0),
        "mlp_down_w": norm((L, Fh, D), std / math.sqrt(2 * L)),
        "mlp_down_b": const((L, D), 0.0),
    }


def _ln(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int, device=None):
    """-> {"k","v": [L, B, max_len, H, hd]} in the activation dtype."""
    from ..device import resolve_device
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _cached_attention(x, params_l, kc, vc, pos, cfg, qmm=quant_matmul):
    """One block's attention with the cache update. x [B,T,D]; kc/vc
    [B,max_len,H,hd] are written in place. Returns the attention out."""
    B, T, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    qkv = leaf_matmul(x, params_l, "qkv_w", qmm)
    if params_l.get("qkv_b") is not None:
        qkv = qkv + params_l["qkv_b"].to(x.dtype)
    q, k, v = torch.split(qkv, D, dim=-1)
    q = q.reshape(B, T, H, hd)
    write_kv(kc, k.reshape(B, T, H, hd), pos)
    write_kv(vc, v.reshape(B, T, H, hd), pos)
    ctx = cached_attention(q, kc, vc, pos)
    ctx = ctx.reshape(B, T, D).to(x.dtype)
    out = leaf_matmul(ctx, params_l, "attn_out_w", qmm)
    if params_l.get("attn_out_b") is not None:
        out = out + params_l["attn_out_b"].to(x.dtype)
    return out


def _position_embedding(wpe, pos, B: int, T: int, device):
    """A scalar pos slices T rows with the start clamped to the table
    (dynamic_slice semantics); a per-row pos [B] gathers with indices
    clipped to the table (take(mode="clip") semantics)."""
    n = wpe.shape[0]
    if not isinstance(pos, torch.Tensor) or pos.dim() == 0:
        start = min(max(int(pos), 0), n - T)
        return wpe[start:start + T][None]
    idx = (pos.to(device=device, dtype=torch.int64)[:, None]
           + torch.arange(T, device=device)).clamp(0, n - 1)
    return wpe[idx]


def gpt_forward_cached(params, tokens, cache, pos, cfg: GPTConfig,
                       qmm=quant_matmul):
    """Forward `tokens` [B,T] against a cache holding `pos` tokens
    (a scalar, or a [B] tensor of per-row slot positions).
    -> (logits [B,T,V], cache), the cache updated in place. `qmm` is the
    dequant-matmul of int8 trees: the kernel wrapper by default, or the
    plain version where a caller wants the forward without the kernel."""
    B, T = tokens.shape
    x = params["wte"][tokens.long()].to(cfg.dtype)
    x = x + _position_embedding(params["wpe"], pos, B, T,
                                x.device).to(cfg.dtype)
    keys = _BLOCK_KEYS_DENSE + tuple(
        k2 for k in _BLOCK_KEYS_DENSE for k2 in (k + "_q", k + "_scale"))
    stacked = {k: params[k] for k in keys if k in params}
    eps = cfg.layer_norm_eps
    for layer in range(cfg.num_layers):
        p = {k: v[layer] for k, v in stacked.items()}
        a_in = _ln(x, p["ln1_scale"], p["ln1_bias"], eps)
        x = x + _cached_attention(a_in, p, cache["k"][layer],
                                  cache["v"][layer], pos, cfg, qmm)
        m_in = _ln(x, p["ln2_scale"], p["ln2_bias"], eps)
        mh = leaf_matmul(m_in, p, "mlp_up_w", qmm)
        if p.get("mlp_up_b") is not None:
            mh = mh + p["mlp_up_b"].to(mh.dtype)
        mh = F.gelu(mh, approximate="tanh")
        m = leaf_matmul(mh, p, "mlp_down_w", qmm)
        if p.get("mlp_down_b") is not None:
            m = m + p["mlp_down_b"].to(m.dtype)
        x = x + m
    x = _ln(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    if "head_q" in params:
        logits = qmm(x, params["head_q"], params["head_scale"])
    else:
        logits = torch.einsum("bsd,vd->bsv", x, params["wte"].to(x.dtype))
    return logits, cache


def greedy_generate(params, prompt, cfg: GPTConfig, max_new_tokens: int,
                    max_len: Optional[int] = None, qmm=quant_matmul):
    """Greedy decode through the KV cache (models/decode.py).
    prompt [B, T0] -> [B, T0 + max_new_tokens]."""
    from .decode import greedy_generate_with
    return greedy_generate_with(
        functools.partial(gpt_forward_cached, qmm=qmm), init_kv_cache,
        params, prompt, cfg, max_new_tokens, max_len)
