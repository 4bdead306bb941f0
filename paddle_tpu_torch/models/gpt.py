"""GPT — the flagship model family: the train step and the cached
(serving) forward.

Counterpart of paddle_tpu/models/gpt.py: `GPTConfig`, `init_gpt_params`
(the same leaf names and stacked [L, ...] shapes, so a JAX params tree
converts one to one — models/convert.py), `_ln`; the training half
`_attention` (with its context-parallel route), `_dense_ffn`,
`_moe_ffn`, `_block`, `_apply_stack` (with the remat policies),
`gpt_forward`, `gpt_loss` (with the MoE aux loss), `init_opt_state`,
`apply_adamw` and `train_step`; the serving half `init_kv_cache`,
`_cached_attention`, `gpt_forward_cached` and `greedy_generate`.

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
does, to hold the step against them).

Sharding (the reference's PARAM_SPECS :115-139, `shard_gpt_params`
:197, and the mesh-aware `_attention` / `_dense_ffn` / head
:243-322, :522): under the planner-driven step (models/facade.py
`_ShardedTrainStep`) the forward runs on each rank's stored shards and
asks the step's ShardLayout (parallel/layout.py) for every weight in
the form it computes with, as the reference lays the step out: the
fused qkv weight gathered whole and projected into this rank's heads
(its tp shards straddle the q/k/v blocks, so slicing a stored shard as
whole heads would be wrong), attention on those heads, the output
projection row-parallel and reduced over tp, the FFN column- then
row-parallel, `wte` gathered whole for the embedding and the tied head;
with `sequence_parallel` and tp > 1, the activations between blocks on
a sequence shard of the tp group. With no layout the code path and its
bits are the single-GPU ones.

Mixture of experts (reference :83-90, :178-193, :347-374, :564-565):
with `num_experts` > 0 the blocks' FFN is parallel/moe.py's `moe_ffn`
over the stacked expert leaves (`gate_w`, `moe_up_w`, ...), each block
returns its load-balancing loss beside x, and `gpt_loss` adds
`moe_aux_weight` times their sum over the layers. Under a mesh with an
'ep' axis each rank holds its experts of every expert leaf, and routing
runs over the global batch (parallel/moe.py). Context parallelism
(reference :277-303): with `context_parallel` "ring" or "ulysses" and
an 'sp' mesh axis, attention runs sequence-sharded over 'sp'
(parallel/context_parallel.py) and everything else alike on every sp
rank.
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
from ..parallel.layout import (column_mm, current_layout, enter, row_mm,
                               weight, whole)
from ..parallel.mesh import P, get_mesh, shard_value, tp_specs
from .losses import fused_softmax_ce
from .remat import POLICIES

__all__ = ["GPTConfig", "PARAM_SPECS", "SERVING_PARAM_SPECS",
           "init_gpt_params", "shard_gpt_params", "gpt_forward",
           "gpt_loss", "value_and_grad", "loss_and_grads",
           "init_opt_state", "apply_adamw", "train_step", "init_kv_cache",
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
    # under a tp > 1 plan, activations between blocks live on a sequence
    # shard of the tp group (Megatron-SP), as the reference's default
    sequence_parallel: bool = True
    # context parallelism for long sequences: "none" | "ring" | "ulysses";
    # attention shards the sequence over the mesh's 'sp' axis
    context_parallel: str = "none"
    # MoE (expert parallel over the mesh's 'ep' axis); 0 experts = dense
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_gate: str = "switch"          # parallel.moe.GATES: naive|switch|gshard
    moe_aux_weight: float = 0.01      # load-balancing loss coefficient

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
_BLOCK_KEYS_MOE = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
                   "qkv_w", "qkv_b", "attn_out_w", "attn_out_b",
                   "gate_w", "moe_up_w", "moe_up_b", "moe_down_w",
                   "moe_down_b")


def _block_keys(cfg) -> tuple:
    return _BLOCK_KEYS_MOE if cfg.num_experts > 0 else _BLOCK_KEYS_DENSE


# Sharding rules (reference gpt.py:115-139): leaf name -> spec over
# (dp, fsdp, pp, mp, ep). Block weights carry the stacked layer axis
# first ('pp'); the expert leaves split their expert dim over 'ep'.
PARAM_SPECS = {
    "wte":        P("mp", "fsdp"),          # vocab-parallel embedding
    "wpe":        P(None, "fsdp"),
    "ln_f_scale": P(None),
    "ln_f_bias":  P(None),
    "ln1_scale":  P("pp", None),
    "ln1_bias":   P("pp", None),
    "ln2_scale":  P("pp", None),
    "ln2_bias":   P("pp", None),
    "qkv_w":      P("pp", "fsdp", "mp"),    # column-parallel
    "qkv_b":      P("pp", "mp"),
    "attn_out_w": P("pp", "mp", "fsdp"),    # row-parallel
    "attn_out_b": P("pp", None),
    "mlp_up_w":   P("pp", "fsdp", "mp"),    # column-parallel
    "mlp_up_b":   P("pp", "mp"),
    "mlp_down_w": P("pp", "mp", "fsdp"),    # row-parallel
    "mlp_down_b": P("pp", None),
    "gate_w":     P("pp", None, None),
    "moe_up_w":   P("pp", "ep", None, "mp"),
    "moe_up_b":   P("pp", "ep", "mp"),
    "moe_down_w": P("pp", "ep", "mp", None),
    "moe_down_b": P("pp", "ep", None),
}

# the serving tensor-parallel table: the same column/row split on the
# serving mesh's single 'tp' axis (reference :149; its consumer,
# ServingEngine(mesh=), is a later ROADMAP A6 item)
SERVING_PARAM_SPECS = tp_specs(PARAM_SPECS)


def init_gpt_params(cfg: GPTConfig, seed: int = 0, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Random parameters drawn with numpy from `seed` (std 0.02, wpe
    0.01, output projections scaled by 1/sqrt(2L), as the reference
    initializes), on `device` (default: the card). With num_experts > 0
    the expert leaves `gate_w` [L, D, E], `moe_up_w` [L, E, D, F],
    `moe_up_b`, `moe_down_w` and `moe_down_b` take the `mlp_*` leaves'
    place."""
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

    params = {
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
    }
    E = cfg.num_experts
    if E > 0:
        params.update({
            "gate_w": norm((L, D, E)),
            "moe_up_w": norm((L, E, D, Fh)),
            "moe_up_b": const((L, E, Fh), 0.0),
            "moe_down_w": norm((L, E, Fh, D), std / math.sqrt(2 * L)),
            "moe_down_b": const((L, E, D), 0.0),
        })
    else:
        params.update({
            "mlp_up_w": norm((L, D, Fh)),
            "mlp_up_b": const((L, Fh), 0.0),
            "mlp_down_w": norm((L, Fh, D), std / math.sqrt(2 * L)),
            "mlp_down_b": const((L, D), 0.0),
        })
    return params


def shard_gpt_params(params, mesh=None):
    """This rank's shard of every leaf of a full tree under PARAM_SPECS
    on `mesh` (default: the ambient one); the tree itself without a
    mesh."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return params
    return {name: shard_value(v, PARAM_SPECS[name], mesh)
            for name, v in params.items()}


def _ln(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


# --------------------------------------------------------- training half
def _local_qkv(w_qkv, b_qkv, cfg, layout):
    """The fused qkv weight [D, 3 * h * hd] and bias of this tp rank's h
    heads: gathered whole first (reference gpt.py:243-276), since its tp
    shards straddle the q/k/v blocks, then cut to the rank's heads in
    the [D, 3, H, hd] view."""
    D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    w = whole(layout, "qkv_w", w_qkv, dtype=cfg.dtype, part=True)
    b = None if b_qkv is None else whole(layout, "qkv_b", b_qkv,
                                         dtype=cfg.dtype, part=True)
    if layout is None or layout.tp == 1:
        return w, b, H
    h0, h1 = layout.heads(H)
    w = w.reshape(D, 3, H, hd)[:, :, h0:h1].reshape(D, 3 * (h1 - h0) * hd)
    if b is not None:
        b = b.reshape(3, H, hd)[:, h0:h1].reshape(-1)
    return w, b, h1 - h0


def _attention(x, w_qkv, b_qkv, w_out, b_out, cfg, layout=None):
    """x [B,S,D] -> the attention block's output [B,S,D]. The fused
    projection is the reference's [D, 3, H, hd] one (gpt.py:269-276) as
    a single matmul whose [B, S, 3D] output is viewed [B, S, 3, H, hd];
    q, k and v are strided views of it, read in place by the kernels.
    Under a layout: this tp rank's heads over the whole sequence, the
    output projection row-parallel, reduced over tp (and scattered over
    the sequence under sequence parallelism) before its bias."""
    hd = cfg.head_dim
    w_qkv, b_qkv, H = _local_qkv(w_qkv, b_qkv, cfg, layout)
    w_out = weight(layout, "attn_out_w", w_out, dtype=x.dtype)
    p = column_mm(layout, enter(layout, x), w_qkv.to(x.dtype))
    if b_qkv is not None:
        p = p + b_qkv.to(x.dtype)
    B, S = p.shape[:2]
    p = p.view(B, S, 3, H, hd)
    if cfg.context_parallel in ("ring", "ulysses"):
        ctx = _cp_attention(p[:, :, 0], p[:, :, 1], p[:, :, 2], cfg, layout)
    else:
        ctx = flash_attention_fn(p[:, :, 0], p[:, :, 1], p[:, :, 2],
                                 causal=True)
    out = row_mm(layout, ctx.reshape(B, S, H * hd), w_out)
    if b_out is not None:
        out = out + weight(layout, "attn_out_b", b_out, dtype=x.dtype)
    return out


def _cp_attention(q, k, v, cfg, layout=None):
    """Causal attention sequence-sharded over the mesh's 'sp' axis
    (reference gpt.py:277-303): q/k/v [B, S, H, hd], alike on every sp
    rank, in; the whole context, alike on every sp rank, out. The ring
    or Ulysses (parallel/context_parallel.py); Ulysses runs this
    module's `flash_attention_fn` on its head shard."""
    from ..parallel import context_parallel as cp
    from ..parallel.mesh import axis_names
    mesh = layout.mesh if layout is not None else get_mesh()
    kind = cfg.context_parallel
    if mesh is None:
        raise ValueError(
            f"context_parallel={kind!r} needs a mesh with an 'sp' axis "
            "(the sharded step's, or parallel.mesh.use_mesh)")
    names = axis_names(mesh)
    if "sp" not in names:
        if "mp" in names or "tp" in names:
            raise NotImplementedError(
                f"context_parallel={kind!r} on the tensor-parallel axis "
                "(the reference's 'mp' fallback) is not ported: ROADMAP "
                "A6e; give the mesh an 'sp' axis")
        raise ValueError(f"context_parallel={kind!r}: mesh axes {names} "
                         "have neither an 'sp' nor an 'mp' axis")
    if layout is not None and layout.tp > 1:
        raise NotImplementedError(
            "context parallelism under tp > 1 is not ported: ROADMAP A6e")
    if kind == "ring":
        return cp.ring_attention(q, k, v, mesh, axis="sp", causal=True)
    return cp.ulysses_attention(q, k, v, mesh, axis="sp", causal=True,
                                attn=flash_attention_fn)


def _dense_ffn(x, up_w, up_b, down_w, down_b, layout=None):
    """The dense FFN; under a layout, column- then row-parallel over
    tp."""
    h = column_mm(layout, enter(layout, x),
                  weight(layout, "mlp_up_w", up_w, dtype=x.dtype))
    if up_b is not None:
        h = h + weight(layout, "mlp_up_b", up_b, dtype=x.dtype)
    h = F.gelu(h, approximate="tanh")
    out = row_mm(layout, h, weight(layout, "mlp_down_w", down_w,
                                   dtype=x.dtype))
    if down_b is not None:
        out = out + weight(layout, "mlp_down_b", down_b, dtype=x.dtype)
    return out


def _moe_ffn(x, gate_w, up_w, up_b, down_w, down_b, cfg, layout=None):
    """The capacity-routed MoE FFN (parallel/moe.py; reference
    gpt.py:347-356): (y, the load-balancing aux loss), the gate and the
    capacity factor from the config. Under a layout the expert leaves
    are this rank's experts, and routing runs over the global batch."""
    from ..parallel.moe import moe_ffn
    if layout is not None:
        if layout.tp > 1:
            raise NotImplementedError(
                "MoE under tp > 1 (the experts' F dim over 'tp') is not "
                "ported: ROADMAP A6e")
        gate_w = weight(layout, "gate_w", gate_w)
        up_w, up_b, down_w, down_b = (
            layout.experts(n, w) for n, w in (
                ("moe_up_w", up_w), ("moe_up_b", up_b),
                ("moe_down_w", down_w), ("moe_down_b", down_b)))
    return moe_ffn(x, gate_w, up_w, up_b, down_w, down_b,
                   gate=cfg.moe_gate,
                   capacity_factor=cfg.expert_capacity_factor,
                   layout=layout)


def _block(params_l, x, cfg, layout=None):
    """One transformer block on the layer slice `params_l` (under a
    layout, this rank's shards of it). Returns (x, aux): the MoE
    load-balancing loss, None for a dense block."""
    def norm(name):
        return weight(layout, name, params_l[name])
    a_in = _ln(x, norm("ln1_scale"), norm("ln1_bias"), cfg.layer_norm_eps)
    x = x + _attention(a_in, params_l["qkv_w"], params_l.get("qkv_b"),
                       params_l["attn_out_w"], params_l.get("attn_out_b"),
                       cfg, layout)
    m_in = _ln(x, norm("ln2_scale"), norm("ln2_bias"), cfg.layer_norm_eps)
    if cfg.num_experts > 0:
        # no checkpoint of its own under "all_but_mlp" (reference
        # gpt.py:370-374)
        m, aux = _moe_ffn(m_in, params_l["gate_w"], params_l["moe_up_w"],
                          params_l["moe_up_b"], params_l["moe_down_w"],
                          params_l["moe_down_b"], cfg, layout)
        return x + m, aux
    ffn_args = (m_in, params_l["mlp_up_w"], params_l.get("mlp_up_b"),
                params_l["mlp_down_w"], params_l.get("mlp_down_b"), layout)
    if cfg.remat and cfg.remat_policy == "all_but_mlp":
        # a checkpoint around the dense FFN alone, inside a block that has
        # none (reference gpt.py:376-384): its 4D-wide hidden activations
        # are recomputed, everything else is saved
        return x + checkpoint(_dense_ffn, *ffn_args,
                              use_reentrant=False), None
    return x + _dense_ffn(*ffn_args), None


def _apply_stack(stacked, x, cfg: GPTConfig, layout=None):
    """The block stack as a loop over layer views of the stacked leaves,
    each block checkpointed per cfg.remat / cfg.remat_policy: "dots",
    "dots_flash" and "offload_dots" through their context_fn
    (models/remat.py), "all_but_mlp" inside `_block`, anything else as
    "full". The layout rides each checkpoint as an argument, so the
    recompute (on autograd's thread) runs the same collectives.
    Returns (x, aux): the MoE loss summed over the layers (f32 zero for
    a dense stack)."""
    layers = {k: v.unbind(0) for k, v in stacked.items()}
    block_remat = cfg.remat and cfg.remat_policy != "all_but_mlp"
    ctx_fn = POLICIES.get(cfg.remat_policy, noop_context_fn)
    aux = None
    for layer in range(cfg.num_layers):
        p = {k: v[layer] for k, v in layers.items()}
        if block_remat:
            x, a = checkpoint(_block, p, x, cfg, layout, use_reentrant=False,
                              context_fn=ctx_fn)
        else:
            x, a = _block(p, x, cfg, layout)
        if a is not None:
            aux = a if aux is None else aux + a
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def gpt_forward(params, tokens, cfg: GPTConfig):
    """tokens [B, S] -> logits [B, S, V] in cfg.dtype. Under the sharded
    step's layout: this rank's rows, and under sequence parallelism its
    sequence shard, [B, S / tp, V]."""
    return _gpt_forward_impl(params, tokens, cfg)[0]


def _gpt_forward_impl(params, tokens, cfg: GPTConfig):
    """-> (logits, the MoE aux loss)."""
    layout = current_layout()
    B, S = tokens.shape
    # the tied table whole (reference :522): every tp rank embeds and
    # unembeds alike, unless sequence parallelism gives each its shard
    wte = weight(layout, "wte", params["wte"], layer=False)
    wpe = weight(layout, "wpe", params["wpe"], layer=False)
    s0, s1 = (0, S) if layout is None else layout.seq_range(S)
    x = F.embedding(tokens[:, s0:s1].long(), wte).to(cfg.dtype)
    x = x + wpe[s0:s1][None].to(cfg.dtype)
    stacked = {k: params[k] for k in _block_keys(cfg) if k in params}
    x, aux = _apply_stack(stacked, x, cfg, layout)
    x = _ln(x, weight(layout, "ln_f_scale", params["ln_f_scale"],
                      layer=False),
            weight(layout, "ln_f_bias", params["ln_f_bias"], layer=False),
            cfg.layer_norm_eps)
    # tied head, "bsd,vd->bsv"
    return x @ wte.to(x.dtype).t(), aux


def gpt_loss(params, batch, cfg: GPTConfig):
    """Causal LM loss of `batch` (tokens [B, S+1], or {"tokens": ...}):
    the mean fused cross entropy of the logits of tokens[:, :-1] against
    tokens[:, 1:] (under the sharded step, over this rank's rows and
    sequence shard), plus moe_aux_weight times the MoE aux loss when
    experts are active (reference gpt.py:564-565; over the global
    batch)."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    layout = current_layout()
    if layout is not None:
        tgt = layout.seq_local(tgt)
    logits, aux = _gpt_forward_impl(params, inp, cfg)
    loss = fused_softmax_ce(logits, tgt)
    if cfg.num_experts > 0:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def value_and_grad(loss_fn, params, batch, cfg):
    """(loss, {leaf: gradient}) of loss_fn(params, batch, cfg) at
    `params`, the port's jax.value_and_grad. Under the sharded step's
    layout the leaves are local shards: the backward runs on the loss
    scaled to this rank's share of the global mean, the gradients come
    back summed over the ranks that hold the same shard, and the loss is
    the global batch's mean."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    layout = current_layout()
    loss = loss_fn(leaves, batch, cfg)
    if layout is None:
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))
    grads = torch.autograd.grad(loss * layout.loss_scale,
                                list(leaves.values()))
    return (layout.global_loss(loss.detach()),
            layout.reduce_grads(dict(zip(leaves, grads))))


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


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int, device=None,
                  heads: Optional[int] = None):
    """-> {"k","v": [L, B, max_len, H, hd]} in the activation dtype
    (`heads` of them where a tensor-parallel engine holds its share)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len,
             cfg.num_heads if heads is None else int(heads), cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def qkv_head_order(hidden: int, tp: int) -> torch.Tensor:
    """The column order that stores GPT's fused qkv (last dim 3D, q|k|v)
    for tensor-parallel serving: chunk r of tp holds rank r's heads of q,
    then of k, then of v, so each rank's contiguous shard is exactly the
    columns its heads compute with. The reference stores the contiguous
    3D/tp block and lets GSPMD regroup inside the tick; a rank here
    holds what it uses, so the tick moves no weights."""
    per = hidden // tp
    return torch.cat([torch.arange(part * hidden + r * per,
                                   part * hidden + (r + 1) * per)
                      for r in range(tp) for part in range(3)])


def _cached_attention(x, params_l, kc, vc, pos, cfg, qmm=quant_matmul,
                      pt=None, layout=None):
    """One block's attention with the cache update. x [B,T,D]; kc/vc
    [B,max_len,H,hd], or pages [P,page_size,H,hd] with the page table
    `pt`, are written in place. Returns the attention out. Under a
    serving `layout` the rank computes its heads (qkv's stored shard is
    its q|k|v columns, qkv_head_order) and the out projection is
    reduced over tp."""
    B, T, D = x.shape
    hd = cfg.head_dim
    row = leaf_matmul if layout is None else layout.row_mm
    qkv = leaf_matmul(x, params_l, "qkv_w", qmm)
    if params_l.get("qkv_b") is not None:
        qkv = qkv + params_l["qkv_b"].to(x.dtype)
    q, k, v = torch.split(qkv, qkv.shape[-1] // 3, dim=-1)
    ctx = write_and_attend(q.reshape(B, T, -1, hd), k.reshape(B, T, -1, hd),
                           v.reshape(B, T, -1, hd), kc, vc, pos, pt)
    ctx = ctx.reshape(B, T, -1).to(x.dtype)
    out = row(ctx, params_l, "attn_out_w", qmm)
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
                       layers: Optional[int] = None, qmm=quant_matmul,
                       layout=None):
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
    there, since layer l's K/V depends only on the layers below it.
    `layout` (parallel/layout.py ServingLayout): the params and cache
    are this rank's tp shards; qkv and mlp_up run column-parallel,
    attn_out and mlp_down row-parallel with one all-reduce each, the
    embedding vocab-parallel, and the logits come back whole.

    With experts the FFN is `_moe_ffn` over this pass's B·T tokens (its
    capacity from that T; reference :801-806) and its aux is dropped;
    the int8 rewrite leaves the expert stacks in fp. An MoE model has
    no tensor-parallel serving layout yet (ROADMAP A6e)."""
    B, T = tokens.shape
    pt = cache.get("pt")
    if layout is None:
        x = params["wte"][tokens.long()].to(cfg.dtype)
        row = leaf_matmul
    else:
        x = layout.embed(params["wte"], tokens, cfg.dtype)
        row = layout.row_mm
    x = x + _position_embedding(params["wpe"], pos, B, T,
                                x.device).to(cfg.dtype)
    moe = cfg.num_experts > 0
    if moe and layout is not None:
        raise NotImplementedError("tensor-parallel serving of an MoE "
                                  "model: ROADMAP A6e")
    block_keys = _block_keys(cfg)
    keys = block_keys + tuple(
        k2 for k in block_keys for k2 in (k + "_q", k + "_scale"))
    stacked = {k: params[k] for k in keys if k in params}
    eps = cfg.layer_norm_eps
    for layer in range(cfg.num_layers if layers is None else int(layers)):
        p = {k: v[layer] for k, v in stacked.items()}
        a_in = _ln(x, p["ln1_scale"], p["ln1_bias"], eps)
        x = x + _cached_attention(a_in, p, cache["k"][layer],
                                  cache["v"][layer], pos, cfg, qmm, pt,
                                  layout)
        m_in = _ln(x, p["ln2_scale"], p["ln2_bias"], eps)
        if moe:
            x = x + _moe_ffn(m_in, p["gate_w"], p["moe_up_w"],
                             p["moe_up_b"], p["moe_down_w"],
                             p["moe_down_b"], cfg)[0]
            continue
        mh = leaf_matmul(m_in, p, "mlp_up_w", qmm)
        if p.get("mlp_up_b") is not None:
            mh = mh + p["mlp_up_b"].to(mh.dtype)
        mh = F.gelu(mh, approximate="tanh")
        m = row(mh, p, "mlp_down_w", qmm)
        if p.get("mlp_down_b") is not None:
            m = m + p["mlp_down_b"].to(m.dtype)
        x = x + m
    x = _ln(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    if "head_q" in params:
        logits = qmm(x, params["head_q"], params["head_scale"])
        head = "head_q"
    else:
        logits = torch.einsum("bsd,vd->bsv", x, params["wte"].to(x.dtype))
        head = "wte"
    if layout is not None:
        logits = layout.gather_logits(logits, head)
    return logits, cache


def greedy_generate(params, prompt, cfg: GPTConfig, max_new_tokens: int,
                    max_len: Optional[int] = None, qmm=quant_matmul):
    """Greedy decode through the KV cache (models/decode.py).
    prompt [B, T0] -> [B, T0 + max_new_tokens]."""
    from .decode import greedy_generate_with
    return greedy_generate_with(
        functools.partial(gpt_forward_cached, qmm=qmm), init_kv_cache,
        params, prompt, cfg, max_new_tokens, max_len)
