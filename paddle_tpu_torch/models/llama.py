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
rebound (chip_smoke.py does).

Sharding (the reference's PARAM_SPECS :79-91, SERVING_PARAM_SPECS :100):
under the planner-driven step the forward asks the step's ShardLayout
(parallel/layout.py) for each weight, as models/gpt.py does: q, gate
and up column-parallel over tp, o and down row-parallel, reduced over
tp after each block half, `wte` gathered whole for the embedding and
the tied head. GQA under tp: each rank holds H / tp query heads, and K
and V reach the flash kernels repeated to those heads (as the reference
repeats them, :173-174). Where tp divides num_kv_heads the rank's k/v
shard holds exactly the KV heads its query heads use; where it does not
(plan_train checks only num_heads and ffn_hidden), the rank gathers
k_w/v_w over tp and takes the KV heads its query heads use. The
reference's Llama has no sequence parallelism. With no layout the code
path and its bits are the single-GPU ones.

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
from ..parallel.layout import (column_mm, current_layout, enter, row_mm,
                               weight, whole)
from ..parallel.mesh import P, tp_specs
from .gpt import _position_embedding, apply_adamw, value_and_grad
from .losses import fused_softmax_ce

__all__ = ["LlamaConfig", "PARAM_SPECS", "SERVING_PARAM_SPECS",
           "init_llama_params", "llama_forward", "llama_loss",
           "loss_and_grads", "train_step", "init_kv_cache",
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

# leaf name -> spec over (dp, fsdp, pp, mp), the reference's table
# (:79-91): column-parallel q/k/v/gate/up, row-parallel o/down, the
# stacked layer axis on 'pp'
PARAM_SPECS = {
    "wte":          P("mp", "fsdp"),
    "norm_f":       P(None),
    "attn_norm":    P("pp", None),
    "q_w":          P("pp", "fsdp", "mp"),
    "k_w":          P("pp", "fsdp", "mp"),
    "v_w":          P("pp", "fsdp", "mp"),
    "o_w":          P("pp", "mp", "fsdp"),
    "ffn_norm":     P("pp", None),
    "gate_w":       P("pp", "fsdp", "mp"),
    "up_w":         P("pp", "fsdp", "mp"),
    "down_w":       P("pp", "mp", "fsdp"),
}

# the serving tensor-parallel table (reference :100; its consumer,
# ServingEngine(mesh=), is a later ROADMAP A6 item)
SERVING_PARAM_SPECS = tp_specs(PARAM_SPECS)


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


def _kv_heads(lp, cfg: LlamaConfig, layout, dtype):
    """(k_w, v_w, n, skip): the k/v weights this tp rank projects (in
    `dtype`), the n KV heads they hold, and how many of their repeated
    heads precede the rank's first query head. With tp dividing
    num_kv_heads (or no layout) the rank's column shard is exactly its
    KV heads; otherwise both leaves are gathered over tp and cut to the
    KV heads the rank's query heads [q0, q1) use (q // group for
    each)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = 1 if layout is None else layout.tp
    if KV % tp == 0:
        return (weight(layout, "k_w", lp["k_w"], dtype=dtype),
                weight(layout, "v_w", lp["v_w"], dtype=dtype), KV // tp, 0)
    group = H // KV
    q0, q1 = layout.heads(H)
    kv0, kv1 = q0 // group, (q1 - 1) // group + 1
    k_w, v_w = (whole(layout, n, lp[n], dtype=dtype,
                      part=True)[:, kv0 * hd:kv1 * hd]
                for n in ("k_w", "v_w"))
    return k_w, v_w, kv1 - kv0, q0 - kv0 * group


def _attention(h, lp, cfg: LlamaConfig, cos, sin, layout=None):
    """h [B, S, D] (normed) -> the attention block's output [B, S, D]
    (under a layout, this tp rank's heads, the output reduced over
    tp)."""
    B, S, _ = h.shape
    hd = cfg.head_dim
    H = cfg.num_heads // (1 if layout is None else layout.tp)
    k_w, v_w, KV, skip = _kv_heads(lp, cfg, layout, h.dtype)
    # one entry into the tensor-parallel region for q, k and v
    x = enter(layout, h)
    q = column_mm(layout, x, weight(layout, "q_w", lp["q_w"],
                                    dtype=h.dtype)).view(B, S, H, hd)
    k = column_mm(layout, x, k_w).view(B, S, KV, hd)
    v = column_mm(layout, x, v_w).view(B, S, KV, hd)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    if KV != H:
        # GQA: each KV head serves num_heads // num_kv_heads consecutive
        # query heads
        group = cfg.num_heads // cfg.num_kv_heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        if k.shape[2] != H:
            # KV heads gathered for a rank whose query heads start or end
            # inside a group
            k, v = k[:, :, skip:skip + H], v[:, :, skip:skip + H]
    ctx = flash_attention_fn(q, k, v, causal=True)
    return row_mm(layout, ctx.reshape(B, S, H * hd),
                  weight(layout, "o_w", lp["o_w"], dtype=h.dtype))


def _block(lp, x, cfg: LlamaConfig, cos, sin, layout=None):
    """One decoder block on the layer slice `lp` (under a layout, this
    rank's shards of it)."""
    h = _rmsnorm(x, weight(layout, "attn_norm", lp["attn_norm"]),
                 cfg.rms_eps)
    x = x + _attention(h, lp, cfg, cos, sin, layout)
    h = _rmsnorm(x, weight(layout, "ffn_norm", lp["ffn_norm"]), cfg.rms_eps)
    # one entry into the tensor-parallel region for gate and up
    hin = enter(layout, h)
    gated = F.silu(column_mm(layout, hin, weight(
        layout, "gate_w", lp["gate_w"], dtype=h.dtype))) * \
        column_mm(layout, hin, weight(layout, "up_w", lp["up_w"],
                                      dtype=h.dtype))
    return x + row_mm(layout, gated, weight(layout, "down_w", lp["down_w"],
                                            dtype=x.dtype))


def llama_forward(params, tokens, cfg: LlamaConfig):
    """tokens [B, S] -> logits [B, S, V] in cfg.dtype (under the sharded
    step's layout, for this rank's rows)."""
    layout = current_layout()
    S = tokens.shape[1]
    # the tied table whole: every tp rank embeds and unembeds alike
    wte = weight(layout, "wte", params["wte"], layer=False)
    x = F.embedding(tokens.long(), wte).to(cfg.dtype)
    cos, sin = _rope_tables(S, cfg.head_dim, cfg.rope_theta, x.device)
    layers = {k: params[k].unbind(0) for k in _BLOCK_KEYS}
    for layer in range(cfg.num_layers):
        lp = {k: v[layer] for k, v in layers.items()}
        if cfg.remat:
            # the layout rides the checkpoint as an argument, so the
            # recompute (on autograd's thread) runs the same collectives
            x = checkpoint(_block, lp, x, cfg, cos, sin, layout,
                           use_reentrant=False)
        else:
            x = _block(lp, x, cfg, cos, sin, layout)
    x = _rmsnorm(x, weight(layout, "norm_f", params["norm_f"], layer=False),
                 cfg.rms_eps)
    # tied head, "bsd,vd->bsv"
    return x @ wte.to(x.dtype).t()


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


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, device=None,
                  heads: Optional[int] = None):
    """-> {"k","v": [L, B, max_len, KV, hd]} in the activation dtype: the
    cache holds KV heads, not query heads (`heads` of them where a
    tensor-parallel engine holds its share)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len,
             cfg.num_kv_heads if heads is None else int(heads),
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _kv_range(layout, lp, cfg: LlamaConfig):
    """The cache's KV heads this rank's query heads attend, as [a, b),
    where its k/v leaves are whole under tp (tp does not divide
    num_kv_heads); None when the rank's cache holds exactly its heads'
    KV (no layout, or the k/v leaves split)."""
    if layout is None or layout.tp == 1 or \
            layout.form(lp, "k_w") == "column":
        return None
    h0, h1 = layout.heads(cfg.num_heads)
    group = cfg.num_heads // cfg.num_kv_heads
    a = h0 // group
    return a, (h1 - 1) // group + 1


def llama_forward_cached(params, tokens, cache, pos, cfg: LlamaConfig,
                         layers: Optional[int] = None, qmm=quant_matmul,
                         layout=None):
    """Forward `tokens` [B, T] against a cache holding `pos` tokens (a
    scalar, or a [B] tensor of per-row slot positions) -> (logits
    [B, T, V], cache), the cache updated in place. `qmm` is the
    dequant-matmul of int8 trees: the kernel wrapper by default, or the
    plain version where a caller wants the forward without the kernel.
    Cache layouts and `layers` (the speculative self-draft: the first
    `layers` blocks, then the final norm and the head) as
    gpt_forward_cached's. `layout` (parallel/layout.py ServingLayout):
    the params and cache are this rank's tp shards; q/k/v/gate/up run
    column-parallel, o and down row-parallel with one all-reduce each,
    the embedding vocab-parallel, and the logits come back whole."""
    B, T = tokens.shape
    pt = cache.get("pt")
    hd = cfg.head_dim
    if layout is None:
        x = params["wte"][tokens.long()].to(cfg.dtype)
        row = leaf_matmul
    else:
        x = layout.embed(params["wte"], tokens, cfg.dtype)
        row = layout.row_mm
    # RoPE over the cache's positions, taken at `pos` with the clamps of
    # GPT's position embedding: [1, T, hd/2] or [B, T, hd/2]
    cos_full, sin_full = cached_rope_tables(cfg, cache)
    cos = _position_embedding(cos_full, pos, B, T, x.device)
    sin = _position_embedding(sin_full, pos, B, T, x.device)
    keys = _BLOCK_KEYS + tuple(
        k2 for k in _BLOCK_KEYS for k2 in (k + "_q", k + "_scale"))
    stacked = {k: params[k] for k in keys if k in params}
    eps = cfg.rms_eps
    kv_heads = None
    for layer in range(cfg.num_layers if layers is None else int(layers)):
        lp = {k: v[layer] for k, v in stacked.items()}
        if layer == 0:
            kv_heads = _kv_range(layout, lp, cfg)
        h = _rmsnorm(x, lp["attn_norm"], eps)
        q = leaf_matmul(h, lp, "q_w", qmm).reshape(B, T, -1, hd)
        k = leaf_matmul(h, lp, "k_w", qmm).reshape(B, T, -1, hd)
        v = leaf_matmul(h, lp, "v_w", qmm).reshape(B, T, -1, hd)
        ctx = write_and_attend(_apply_rope(q, cos, sin),
                               _apply_rope(k, cos, sin), v,
                               cache["k"][layer], cache["v"][layer], pos, pt,
                               kv_heads=kv_heads)
        x = x + row(ctx.reshape(B, T, -1).to(x.dtype), lp, "o_w", qmm)
        h = _rmsnorm(x, lp["ffn_norm"], eps)
        gated = F.silu(leaf_matmul(h, lp, "gate_w", qmm)) * \
            leaf_matmul(h, lp, "up_w", qmm)
        x = x + row(gated, lp, "down_w", qmm)
    x = _rmsnorm(x, params["norm_f"], eps)
    if "head_q" in params:
        # the tied head's transposed int8 copy; `wte` stays fp for the
        # embedding (quantization/serving.py)
        logits = qmm(x, params["head_q"], params["head_scale"])
        head = "head_q"
    else:
        logits = torch.einsum("bsd,vd->bsv", x, params["wte"].to(x.dtype))
        head = "wte"
    if layout is not None:
        logits = layout.gather_logits(logits, head)
    return logits, cache


def greedy_generate(params, prompt, cfg: LlamaConfig, max_new_tokens: int,
                    max_len: Optional[int] = None, qmm=quant_matmul):
    """Greedy decode through the grouped KV cache (models/decode.py).
    prompt [B, T0] -> [B, T0 + max_new_tokens]."""
    from .decode import greedy_generate_with
    return greedy_generate_with(
        functools.partial(llama_forward_cached, qmm=qmm), init_kv_cache,
        params, prompt, cfg, max_new_tokens, max_len)
