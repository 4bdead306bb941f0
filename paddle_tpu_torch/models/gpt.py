"""GPT — the flagship model family: the train step and the cached
(serving) forward.

Counterpart of paddle_tpu/models/gpt.py: `GPTConfig`, `init_gpt_params`
(the same leaf names and stacked [L, ...] shapes, so a JAX params tree
converts one to one — models/convert.py), `_ln`; the training half
`_attention`, `_dense_ffn`, `_block`, `_apply_stack` (with the remat
policies), `gpt_forward`, `gpt_loss`, `init_opt_state`, `apply_adamw`
and `train_step`; the serving half `init_kv_cache`, `_cached_attention`,
`gpt_forward_cached` and `greedy_generate`.

The reference scans the stacked leaves with lax.scan; here a Python
loop over the layer axis indexes them (`leaf[l]` is a view, so nothing
is copied). The KV cache {"k","v": [L, B, max_len, H, hd]}, or the
serving engine's page pool {"k","v": [L, P, page_size, H, hd], "pt":
[B, max_pages]}, is written in place (kernels/decode_attention).

Numerics kept from the reference: LayerNorm statistics in f32 with eps
1e-5, cast back to the activation dtype; GELU in its tanh form (the
default of jax.nn.gelu); the fp head is einsum("bsd,vd->bsv") in the
activation dtype; the int8 head is the fused dequant-matmul.

The train step runs attention through the flash kernels
(kernels/flash_attention.py) and the loss through the CE route the
port's registry selects (models/losses.py: by default the two-pass CE
kernels); the AdamW update is plain torch per leaf, as the reference's
default jax-level update is, unless the registry selects the fused
kernel. `_attention` and `gpt_loss` look `flash_attention_fn` and
`fused_softmax_ce` up in this module's namespace at each call, so the
same step runs on the kernels' plain versions once those two names are
rebound to partials with `fwd=mha_fwd_ref, bwd=mha_bwd_ref` and
`fwd=ce_fwd_ref, bwd=ce_bwd_ref, fused=ce_fused_ref` (chip_smoke.py
does, to hold the step against them). The single-GPU path has no mesh,
so the reference's sharding constraints have nothing to pin and are not
carried.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..kernels.decode_attention import write_and_attend
from ..kernels.flash_attention import flash_attention_fn
from ..kernels.fused_update import fused_apply_adamw, fused_update_enabled
from ..kernels.quant_matmul import leaf_matmul, quant_matmul
from .losses import fused_softmax_ce
from .remat import POLICIES

__all__ = ["GPTConfig", "init_gpt_params", "gpt_forward", "gpt_loss",
           "value_and_grad", "loss_and_grads", "init_opt_state",
           "apply_adamw", "train_step", "init_kv_cache",
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
    remat: bool = True                        # checkpoint each block
    # "full" recomputes the whole block in the backward; "dots" saves the
    # matmul outputs and recomputes the rest, the flash forward included
    # (JAX's dots_with_no_batch_dims_saveable); "dots_flash" saves the
    # flash forward's outputs too, so no attention reruns; "offload_dots"
    # keeps what "dots" saves in pinned host memory; "all_but_mlp" puts
    # no checkpoint around the block and one around the dense FFN alone
    # (models/remat.py)
    remat_policy: str = "full"

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


# --------------------------------------------------------- training half
def _attention(x, w_qkv, b_qkv, w_out, b_out, cfg):
    """x [B,S,D] -> the attention block's output [B,S,D]. The fused
    projection is the reference's [D, 3, H, hd] one (gpt.py:269-276) as
    a single matmul whose [B, S, 3D] output is viewed [B, S, 3, H, hd];
    q, k and v are strided views of it, read in place by the kernels."""
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    p = x @ w_qkv.to(x.dtype)
    if b_qkv is not None:
        p = p + b_qkv.to(x.dtype)
    p = p.view(B, S, 3, H, hd)
    ctx = flash_attention_fn(p[:, :, 0], p[:, :, 1], p[:, :, 2],
                             causal=True)
    out = ctx.reshape(B, S, D) @ w_out.to(x.dtype)
    if b_out is not None:
        out = out + b_out.to(x.dtype)
    return out


def _dense_ffn(x, up_w, up_b, down_w, down_b):
    h = x @ up_w.to(x.dtype)
    if up_b is not None:
        h = h + up_b.to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    out = h @ down_w.to(x.dtype)
    if down_b is not None:
        out = out + down_b.to(x.dtype)
    return out


def _block(params_l, x, cfg):
    """One transformer block on the layer slice `params_l`."""
    a_in = _ln(x, params_l["ln1_scale"], params_l["ln1_bias"],
               cfg.layer_norm_eps)
    x = x + _attention(a_in, params_l["qkv_w"], params_l.get("qkv_b"),
                       params_l["attn_out_w"], params_l.get("attn_out_b"),
                       cfg)
    m_in = _ln(x, params_l["ln2_scale"], params_l["ln2_bias"],
               cfg.layer_norm_eps)
    ffn_args = (m_in, params_l["mlp_up_w"], params_l.get("mlp_up_b"),
                params_l["mlp_down_w"], params_l.get("mlp_down_b"))
    if cfg.remat and cfg.remat_policy == "all_but_mlp":
        # a checkpoint around the dense FFN alone, inside a block that has
        # none (reference gpt.py:376-384): its 4D-wide hidden activations
        # are recomputed, everything else is saved
        return x + checkpoint(_dense_ffn, *ffn_args, use_reentrant=False)
    return x + _dense_ffn(*ffn_args)


def _apply_stack(stacked, x, cfg: GPTConfig):
    """The block stack as a loop over layer views of the stacked leaves,
    each block checkpointed per cfg.remat / cfg.remat_policy: "dots",
    "dots_flash" and "offload_dots" through their context_fn
    (models/remat.py), "all_but_mlp" inside `_block`, anything else as
    "full"."""
    layers = {k: v.unbind(0) for k, v in stacked.items()}
    block_remat = cfg.remat and cfg.remat_policy != "all_but_mlp"
    ctx_fn = POLICIES.get(cfg.remat_policy, noop_context_fn)
    for layer in range(cfg.num_layers):
        p = {k: v[layer] for k, v in layers.items()}
        if block_remat:
            x = checkpoint(_block, p, x, cfg, use_reentrant=False,
                           context_fn=ctx_fn)
        else:
            x = _block(p, x, cfg)
    return x


def gpt_forward(params, tokens, cfg: GPTConfig):
    """tokens [B, S] -> logits [B, S, V] in cfg.dtype."""
    B, S = tokens.shape
    x = F.embedding(tokens.long(), params["wte"]).to(cfg.dtype)
    x = x + params["wpe"][:S][None].to(cfg.dtype)
    stacked = {k: params[k] for k in _BLOCK_KEYS_DENSE if k in params}
    x = _apply_stack(stacked, x, cfg)
    x = _ln(x, params["ln_f_scale"], params["ln_f_bias"], cfg.layer_norm_eps)
    # tied head, "bsd,vd->bsv"
    return x @ params["wte"].to(x.dtype).t()


def gpt_loss(params, batch, cfg: GPTConfig):
    """Causal LM loss of `batch` (tokens [B, S+1], or {"tokens": ...}):
    the mean fused cross entropy of the logits of tokens[:, :-1] against
    tokens[:, 1:]."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    return fused_softmax_ce(gpt_forward(params, inp, cfg), tgt)


def value_and_grad(loss_fn, params, batch, cfg):
    """(loss, {leaf: gradient}) of loss_fn(params, batch, cfg) at
    `params`, the port's jax.value_and_grad."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves, batch, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def loss_and_grads(params, batch, cfg: GPTConfig):
    """(loss, {leaf: gradient}) of gpt_loss at `params`."""
    return value_and_grad(gpt_loss, params, batch, cfg)


def init_opt_state(params):
    """AdamW state: f32 moments like each leaf, and the step count."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.float32, device=dev),
    }


@torch.no_grad()
def apply_adamw(grads, params, opt_state, lr, beta1=0.9, beta2=0.95,
                eps=1e-8, weight_decay=0.1):
    """One AdamW update over the param tree, the reference's default
    jax-level rule (gpt.py:598-620): f32 moments, bias corrections from
    the step, decoupled decay p * (1 - lr * wd), the param stored back in
    its own dtype. Unlike the reference, which returns new trees, this
    updates `params` and `opt_state` IN PLACE (their buffers are reused,
    as JAX's donation aliases them) and returns them. Shared by the GPT
    and Llama train steps.

    Where the registry names "pallas" for "fused_update" and the leaves
    are on the card, every leaf goes through the fused kernel instead
    (kernels/fused_update.py, as gpt.py:592-597 consults it); this plain
    per-leaf loop stays the default and the parity oracle."""
    if fused_update_enabled(opt_state["step"].device):
        return fused_apply_adamw(grads, params, opt_state, lr, beta1=beta1,
                                 beta2=beta2, eps=eps,
                                 weight_decay=weight_decay)
    step = opt_state["step"].add_(1.0)
    bc1 = 1.0 - beta1 ** step
    bc2 = 1.0 - beta2 ** step
    for k, p in params.items():
        gf = grads[k].float()
        m, v = opt_state["m"][k], opt_state["v"][k]
        m.mul_(beta1).add_(gf, alpha=1 - beta1)
        v.mul_(beta2).addcmul_(gf, gf, value=1 - beta2)
        den = torch.sqrt(v / bc2) + eps
        p.copy_(p.float() * (1.0 - lr * weight_decay)
                - lr * (m / bc1) / den)
    return params, opt_state


def train_step(params, opt_state, batch, cfg: GPTConfig, lr=3e-4,
               beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1):
    """One step: the loss and its gradients, then AdamW. Returns (loss,
    params, opt_state); params and opt_state are updated in place."""
    loss, grads = loss_and_grads(params, batch, cfg)
    apply_adamw(grads, params, opt_state, lr, beta1=beta1, beta2=beta2,
                eps=eps, weight_decay=weight_decay)
    return loss, params, opt_state


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int, device=None):
    """-> {"k","v": [L, B, max_len, H, hd]} in the activation dtype."""
    from ..device import resolve_device
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _cached_attention(x, params_l, kc, vc, pos, cfg, qmm=quant_matmul,
                      pt=None):
    """One block's attention with the cache update. x [B,T,D]; kc/vc
    [B,max_len,H,hd], or pages [P,page_size,H,hd] with the page table
    `pt`, are written in place. Returns the attention out."""
    B, T, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    qkv = leaf_matmul(x, params_l, "qkv_w", qmm)
    if params_l.get("qkv_b") is not None:
        qkv = qkv + params_l["qkv_b"].to(x.dtype)
    q, k, v = torch.split(qkv, D, dim=-1)
    ctx = write_and_attend(q.reshape(B, T, H, hd), k.reshape(B, T, H, hd),
                           v.reshape(B, T, H, hd), kc, vc, pos, pt)
    ctx = ctx.reshape(B, T, D).to(x.dtype)
    out = leaf_matmul(ctx, params_l, "attn_out_w", qmm)
    if params_l.get("attn_out_b") is not None:
        out = out + params_l["attn_out_b"].to(x.dtype)
    return out


def _position_embedding(wpe, pos, B: int, T: int, device):
    """Rows of a position table (GPT's wpe, Llama's RoPE tables) for T
    tokens at `pos`. A scalar pos slices T rows with the start clamped
    to the table (dynamic_slice semantics) -> [1, T, ...]; a per-row pos
    [B] gathers with indices clipped to the table (take(mode="clip")
    semantics) -> [B, T, ...]."""
    n = wpe.shape[0]
    if not isinstance(pos, torch.Tensor) or pos.dim() == 0:
        start = min(max(int(pos), 0), n - T)
        return wpe[start:start + T][None]
    idx = (pos.to(device=device, dtype=torch.int64)[:, None]
           + torch.arange(T, device=device)).clamp(0, n - 1)
    return wpe[idx]


def gpt_forward_cached(params, tokens, cache, pos, cfg: GPTConfig,
                       layers: Optional[int] = None, qmm=quant_matmul):
    """Forward `tokens` [B,T] against a cache holding `pos` tokens
    (a scalar, or a [B] tensor of per-row slot positions).
    -> (logits [B,T,V], cache), the cache updated in place. `qmm` is the
    dequant-matmul of int8 trees: the kernel wrapper by default, or the
    plain version where a caller wants the forward without the kernel.

    The cache is dense {"k","v": [L, B, max_len, H, hd]} or the serving
    engine's page pool {"k","v": [L, P, page_size, H, hd], "pt": [B,
    max_pages]}, the page table riding the dict. `layers` runs the first
    `layers` blocks only, then the final norm and the head: the
    self-draft pass of speculative decoding (inference/spec_decode.py).
    It writes layers < `layers` of the cache it is given (the whole cache
    or its first-`layers` view), with the bits the full pass writes
    there, since layer l's K/V depends only on the layers below it."""
    B, T = tokens.shape
    pt = cache.get("pt")
    x = params["wte"][tokens.long()].to(cfg.dtype)
    x = x + _position_embedding(params["wpe"], pos, B, T,
                                x.device).to(cfg.dtype)
    keys = _BLOCK_KEYS_DENSE + tuple(
        k2 for k in _BLOCK_KEYS_DENSE for k2 in (k + "_q", k + "_scale"))
    stacked = {k: params[k] for k in keys if k in params}
    eps = cfg.layer_norm_eps
    for layer in range(cfg.num_layers if layers is None else int(layers)):
        p = {k: v[layer] for k, v in stacked.items()}
        a_in = _ln(x, p["ln1_scale"], p["ln1_bias"], eps)
        x = x + _cached_attention(a_in, p, cache["k"][layer],
                                  cache["v"][layer], pos, cfg, qmm, pt)
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
