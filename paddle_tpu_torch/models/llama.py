"""Llama-family decoder, the training half: RMSNorm, RoPE, grouped-query
attention and SwiGLU over stacked per-layer leaves.

Counterpart of paddle_tpu/models/llama.py: `LlamaConfig` (:44),
`init_llama_params` (:103, the same leaf names, stacked [L, ...] shapes
and init scales, so a JAX params tree converts one to one with
models/convert.py), `_rmsnorm` (:127), `_rope_tables` (:133),
`_apply_rope` (:140), `_block` (:161), `llama_forward` (:190),
`llama_loss` (:207) and `train_step` (:217), which shares the GPT step's
update rule (models/gpt.py apply_adamw).

The reference scans the stacked leaves with lax.scan and wraps each
block in a full jax.checkpoint when cfg.remat (:196-197); here a Python
loop over `unbind(0)` views runs each block under
torch.utils.checkpoint, so the backward recomputes the whole block, the
flash forward included.

Numerics kept from the reference: RMSNorm in f32 with the scale applied
in f32, cast back to the activation dtype; RoPE rotates interleaved
pairs (x[..., 0::2], x[..., 1::2]) in f32; SiLU(gate) * up in the
activation dtype; the head is tied to `wte` (:204). Grouped-query
attention repeats each KV head over H // KV query heads with
`repeat_interleave` (jnp.repeat's order) before the flash kernels, which
take equal head counts, as the reference does (:171-174).

`_attention` and `llama_loss` look `flash_attention_fn` and
`fused_softmax_ce` up in this module's namespace at each call, so the
same step runs on the kernels' plain versions once those two names are
rebound (chip_smoke.py does). The cached serving half (`init_kv_cache`,
`llama_forward_cached`, `greedy_generate`) is ROADMAP A4. The
single-GPU path has no mesh, so the reference's sharding constraints
have nothing to pin and are not carried.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention_fn
from .gpt import apply_adamw, value_and_grad
from .losses import fused_softmax_ce

__all__ = ["LlamaConfig", "init_llama_params", "llama_forward",
           "llama_loss", "loss_and_grads", "train_step"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None        # None -> MHA
    ffn_hidden: Optional[int] = None          # None -> 8/3 * D, mult of 256
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True                        # checkpoint each block

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.ffn_hidden is None:
            self.ffn_hidden = ((8 * self.hidden_size // 3 + 255)
                               // 256) * 256
        assert self.hidden_size % self.num_heads == 0
        assert self.num_heads % self.num_kv_heads == 0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


_BLOCK_KEYS = ("attn_norm", "q_w", "k_w", "v_w", "o_w",
               "ffn_norm", "gate_w", "up_w", "down_w")


def init_llama_params(cfg: LlamaConfig, seed: int = 0, device=None
                      ) -> Dict[str, torch.Tensor]:
    """Random parameters drawn with numpy from `seed` (std 0.02, output
    projections scaled by 1/sqrt(2L), norms at 1, as the reference
    initializes), on `device` (default: the card)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, Fh, L = cfg.hidden_size, cfg.ffn_hidden, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out_std = 0.02 / math.sqrt(2 * L)

    def norm(shape, scale=0.02):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return torch.from_numpy(a).to(dev, cfg.param_dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.param_dtype, device=dev)

    return {
        "wte": norm((cfg.vocab_size, D)),
        "norm_f": ones((D,)),
        "attn_norm": ones((L, D)),
        "q_w": norm((L, D, H * hd)),
        "k_w": norm((L, D, KV * hd)),
        "v_w": norm((L, D, KV * hd)),
        "o_w": norm((L, H * hd, D), out_std),
        "ffn_norm": ones((L, D)),
        "gate_w": norm((L, D, Fh)),
        "up_w": norm((L, D, Fh)),
        "down_w": norm((L, Fh, D), out_std),
    }


def _rmsnorm(x, scale, eps):
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * r * scale.float()).to(x.dtype)


def _rope_tables(seq: int, hd: int, theta: float, device=None):
    """(cos, sin) [S, hd/2] f32: the half-dim frequency ladder."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=device) / hd))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x, cos, sin):
    """x [B, S, H, hd]; rotate interleaved pairs by the position angle of
    cos/sin [S, hd/2] (positions shared by every row)."""
    B, S, H, hd = x.shape
    xf = x.float().reshape(B, S, H, hd // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    rot = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], -1)
    return rot.reshape(B, S, H, hd).to(x.dtype)


def _attention(h, lp, cfg: LlamaConfig, cos, sin):
    """h [B, S, D] (normed) -> the attention block's output [B, S, D]."""
    B, S, _ = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (h @ lp["q_w"].to(h.dtype)).view(B, S, H, hd)
    k = (h @ lp["k_w"].to(h.dtype)).view(B, S, KV, hd)
    v = (h @ lp["v_w"].to(h.dtype)).view(B, S, KV, hd)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    if KV != H:
        # GQA: each KV head serves H // KV consecutive query heads
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    ctx = flash_attention_fn(q, k, v, causal=True)
    return ctx.reshape(B, S, H * hd) @ lp["o_w"].to(h.dtype)


def _block(lp, x, cfg: LlamaConfig, cos, sin):
    """One decoder block on the layer slice `lp`."""
    x = x + _attention(_rmsnorm(x, lp["attn_norm"], cfg.rms_eps), lp, cfg,
                       cos, sin)
    h = _rmsnorm(x, lp["ffn_norm"], cfg.rms_eps)
    gated = F.silu(h @ lp["gate_w"].to(h.dtype)) * (h @ lp["up_w"].to(h.dtype))
    return x + gated @ lp["down_w"].to(x.dtype)


def llama_forward(params, tokens, cfg: LlamaConfig):
    """tokens [B, S] -> logits [B, S, V] in cfg.dtype."""
    S = tokens.shape[1]
    x = F.embedding(tokens.long(), params["wte"]).to(cfg.dtype)
    cos, sin = _rope_tables(S, cfg.head_dim, cfg.rope_theta, x.device)
    layers = {k: params[k].unbind(0) for k in _BLOCK_KEYS}
    for layer in range(cfg.num_layers):
        lp = {k: v[layer] for k, v in layers.items()}
        if cfg.remat:
            x = checkpoint(_block, lp, x, cfg, cos, sin, use_reentrant=False)
        else:
            x = _block(lp, x, cfg, cos, sin)
    x = _rmsnorm(x, params["norm_f"], cfg.rms_eps)
    # tied head, "bsd,vd->bsv"
    return x @ params["wte"].to(x.dtype).t()


def llama_loss(params, batch, cfg: LlamaConfig):
    """Causal LM loss over tokens [B, S+1] (input = [:, :-1], target =
    [:, 1:]): the mean cross entropy of the logits."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    return fused_softmax_ce(llama_forward(params, inp, cfg), tgt)


def loss_and_grads(params, batch, cfg: LlamaConfig):
    """(loss, {leaf: gradient}) of llama_loss at `params`."""
    return value_and_grad(llama_loss, params, batch, cfg)


def train_step(params, opt_state, batch, cfg: LlamaConfig, lr=3e-4,
               **adamw_kw):
    """One step: the loss and its gradients, then the GPT step's AdamW
    (gpt.apply_adamw). Returns (loss, params, opt_state); params and
    opt_state are updated in place."""
    loss, grads = loss_and_grads(params, batch, cfg)
    apply_adamw(grads, params, opt_state, lr, **adamw_kw)
    return loss, params, opt_state
