"""Llama-family decoder: RMSNorm, RoPE, grouped-query attention and
SwiGLU over stacked per-layer leaves; the train step and the cached
(serving) forward.

Counterpart of paddle_tpu/models/llama.py: `LlamaConfig` (:44),
`init_llama_params` (:103, the same leaf names, stacked [L, ...] shapes
and init scales, so a JAX params tree converts one to one with
models/convert.py), `_rmsnorm` (:127), `_rope_tables` (:133),
`_apply_rope` (:140), `_block` (:161), `llama_forward` (:190),
`llama_loss` (:207) and `train_step` (:217), which shares the GPT step's
update rule (models/gpt.py apply_adamw); the serving half
`init_kv_cache` (:235), `llama_forward_cached` (:243) and
`greedy_generate` (:339).

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
rebound (chip_smoke.py does). The single-GPU path has no mesh, so the
reference's sharding constraints have nothing to pin and are not
carried.

The cached forward keeps the reference's layouts: a dense cache of KV
heads {"k","v": [L, B, max_len, KV, hd]} or the serving engine's page
pool {"k","v": [L, P, page_size, KV, hd], "pt": [B, max_pages]}, written
in place (kernels/decode_attention), and grouped masked attention over
it that never repeats KV (cached_attention folds the group axis). RoPE
runs at absolute positions from tables built over the cache's logical
length (max_len, or max_pages * page_size); a
scalar `pos` slices them with the start clamped (dynamic_slice), a [B]
`pos` gathers with indices clamped to the table (take(mode="clip")), so
a row parked past the cache ropes at the last position instead of
raising. Every block matmul goes through leaf_matmul, so an int8 tree
(quantization/serving.py) runs the fused dequant-matmul, the tied head
too (`head_q`); `qmm=` swaps that matmul for its plain version, as
gpt_forward_cached's does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attention import write_and_attend
from ..kernels.flash_attention import flash_attention_fn
from ..kernels.quant_matmul import leaf_matmul, quant_matmul
from .gpt import _position_embedding, apply_adamw, value_and_grad
from .losses import fused_softmax_ce

__all__ = ["LlamaConfig", "init_llama_params", "llama_forward",
           "llama_loss", "loss_and_grads", "train_step", "init_kv_cache",
           "llama_forward_cached", "greedy_generate"]


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


@functools.lru_cache(maxsize=16)
def _rope_tables(seq: int, hd: int, theta: float, device=None):
    """(cos, sin) [S, hd/2] f32: the half-dim frequency ladder. Built
    once per (seq, hd, theta, device), as the reference's are at trace
    time; callers only read them."""
    with torch.inference_mode(False):
        inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                            device=device) / hd))
        ang = torch.arange(seq, dtype=torch.float32,
                           device=device)[:, None] * inv[None, :]
        return torch.cos(ang), torch.sin(ang)


def cached_rope_tables(cfg: LlamaConfig, cache):
    """The (cos, sin) tables `llama_forward_cached` reads for `cache`,
    over its length (dense: max_len; paged: the table's reach). The
    cache of `_rope_tables` may evict and free them, so whoever holds a
    CUDA graph that baked their addresses keeps this pair with it."""
    pt = cache.get("pt")
    s_cache = cache["k"].shape[2] * (1 if pt is None else pt.shape[1])
    return _rope_tables(s_cache, cfg.head_dim, cfg.rope_theta,
                        cache["k"].device)


def _apply_rope(x, cos, sin):
    """x [B, S, H, hd]; rotate interleaved pairs by the position angle.
    cos/sin are [S, hd/2] (positions shared by every row) or
    [B, S, hd/2] (per-row positions: the serving engine's slot decode)."""
    B, S, H, hd = x.shape
    xf = x.float().reshape(B, S, H, hd // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    if cos.dim() == 2:
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
    else:
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
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


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, device=None):
    """-> {"k","v": [L, B, max_len, KV, hd]} in the activation dtype: the
    cache holds KV heads, not query heads."""
    from ..device import resolve_device
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def llama_forward_cached(params, tokens, cache, pos, cfg: LlamaConfig,
                         layers: Optional[int] = None, qmm=quant_matmul):
    """Forward `tokens` [B, T] against a cache holding `pos` tokens (a
    scalar, or a [B] tensor of per-row slot positions) -> (logits
    [B, T, V], cache), the cache updated in place. `qmm` is the
    dequant-matmul of int8 trees: the kernel wrapper by default, or the
    plain version where a caller wants the forward without the kernel.
    Cache layouts and `layers` (the speculative self-draft: the first
    `layers` blocks, then the final norm and the head) as
    gpt_forward_cached's."""
    B, T = tokens.shape
    pt = cache.get("pt")
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = params["wte"][tokens.long()].to(cfg.dtype)
    # RoPE over the cache's positions, taken at `pos` with the clamps of
    # GPT's position embedding: [1, T, hd/2] or [B, T, hd/2]
    cos_full, sin_full = cached_rope_tables(cfg, cache)
    cos = _position_embedding(cos_full, pos, B, T, x.device)
    sin = _position_embedding(sin_full, pos, B, T, x.device)
    keys = _BLOCK_KEYS + tuple(
        k2 for k in _BLOCK_KEYS for k2 in (k + "_q", k + "_scale"))
    stacked = {k: params[k] for k in keys if k in params}
    eps = cfg.rms_eps
    for layer in range(cfg.num_layers if layers is None else int(layers)):
        lp = {k: v[layer] for k, v in stacked.items()}
        h = _rmsnorm(x, lp["attn_norm"], eps)
        q = leaf_matmul(h, lp, "q_w", qmm).reshape(B, T, H, hd)
        k = leaf_matmul(h, lp, "k_w", qmm).reshape(B, T, KV, hd)
        v = leaf_matmul(h, lp, "v_w", qmm).reshape(B, T, KV, hd)
        ctx = write_and_attend(_apply_rope(q, cos, sin),
                               _apply_rope(k, cos, sin), v,
                               cache["k"][layer], cache["v"][layer], pos, pt)
        x = x + leaf_matmul(ctx.reshape(B, T, H * hd).to(x.dtype), lp,
                            "o_w", qmm)
        h = _rmsnorm(x, lp["ffn_norm"], eps)
        gated = F.silu(leaf_matmul(h, lp, "gate_w", qmm)) * \
            leaf_matmul(h, lp, "up_w", qmm)
        x = x + leaf_matmul(gated, lp, "down_w", qmm)
    x = _rmsnorm(x, params["norm_f"], eps)
    if "head_q" in params:
        # the tied head's transposed int8 copy; `wte` stays fp for the
        # embedding (quantization/serving.py)
        logits = qmm(x, params["head_q"], params["head_scale"])
    else:
        logits = torch.einsum("bsd,vd->bsv", x, params["wte"].to(x.dtype))
    return logits, cache


def greedy_generate(params, prompt, cfg: LlamaConfig, max_new_tokens: int,
                    max_len: Optional[int] = None, qmm=quant_matmul):
    """Greedy decode through the grouped KV cache (models/decode.py).
    prompt [B, T0] -> [B, T0 + max_new_tokens]."""
    from .decode import greedy_generate_with
    return greedy_generate_with(
        functools.partial(llama_forward_cached, qmm=qmm), init_kv_cache,
        params, prompt, cfg, max_new_tokens, max_len)
