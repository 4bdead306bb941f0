"""Mixture-of-Experts: gates, capacity-based routing, expert parallelism.

Counterpart of paddle_tpu/parallel/moe.py (`compute_capacity` :31,
`topk_gating` :38, `GateSpec`/`GATES` :89-101, `moe_ffn` :104,
`MoELayer` :160).

The same function, not the same program. The reference builds one-hot
dispatch and combine tensors [T, E, C] and moves tokens with the einsums
"td,tec->ecd" and "ecd,tec->td", which cost T·E·C·D multiply-adds each
(at GPT's widths as much as the experts' own matmuls). Here routing
gives each kept (token, choice) an expert and a slot, the experts' slot
rows are gathered from the tokens (`index_select`, whose backward is an
index-add), and each token gathers back its choices' outputs. A one-hot contraction has one nonzero
term a slot, so the gather gives its bits; top-2 sums its two terms in
f32 and rounds once, as the einsum's f32 accumulation does. The expert
matmuls are batched products ([E, C, D] @ [E, D, F]), as the reference
leaves them to XLA.

Numerics kept from the reference: gate logits and softmax in f32; a
token's slot in its expert is the count of earlier tokens that chose
that expert in this round plus the kept counts of earlier rounds
(`prior_count`); a token past capacity is dropped and contributes zero;
`normalize` defaults to k > 1; the combine weights are cast to the
activation dtype before they scale; GELU in its tanh form; the naive
gate's value multiplies after the expert sum, in the activation dtype;
aux = E · Σₑ mean_T(probs)·mean_T(top-1 one-hot).

Expert parallelism (`moe_ffn(..., layout=)`, the sharded step's
parallel/layout.py ShardLayout): the reference jits global shapes and
GSPMD lowers the expert dim, sharded over 'ep', to all-to-alls. Its
routing is a function of the global batch, so under dp/fsdp each batch
rank exchanges what routing needs, and nothing else:
- each round's per-expert counts ([k, E] f32, exact), all-gathered over
  the batch axes in batch-shard order: C comes from the global T, and a
  token's slot counts the earlier tokens of every batch rank before it;
- the column sums of probs, all-reduced (forward and backward), and the
  top-1 counts, for aux's two means over the global T.
A token's expert output depends on that token alone, so each rank
computes its own tokens' outputs: it packs its kept tokens into its
experts' slots (a rank's kept tokens of an expert never exceed C, nor
its k·T_local choices), the 'ep' rank only for the experts it holds.
Tokens are not split over 'ep': every ep rank of a batch shard routes
alike and fills its own experts' slots; its combined output is a partial
sum,
reduced over 'ep' in f32 and rounded once, as `row_mm` does over tp.
The expert path's input enters through `copy_to` (its gradient summed
over 'ep'), and so do the combine weights, which each ep rank uses for
its own experts only: the gate's gradient is then whole on every ep
rank, as the router is replicated there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .collective import all_gather, all_reduce_sum, copy_to, reduce_from

__all__ = ["compute_capacity", "topk_gating", "GateSpec", "GATES",
           "moe_ffn", "MoELayer", "Routing", "route_tokens"]


def compute_capacity(num_tokens: int, num_experts: int,
                     capacity_factor: float, min_capacity: int = 4) -> int:
    """Per-expert token slots (reference switch/gshard capacity rule)."""
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


@dataclasses.dataclass
class GateSpec:
    """Gate zoo entry (reference moe/gate/*.py)."""
    name: str
    top_k: int
    use_capacity: bool


GATES = {
    "naive": GateSpec("naive", 1, False),    # dense masked, no drops
    "switch": GateSpec("switch", 1, True),   # top-1 + capacity
    "gshard": GateSpec("gshard", 2, True),   # top-2 + capacity
}


class Routing(NamedTuple):
    """Where each of a rank's T tokens goes, one entry a round.
    expert [k, T] (long), keep [k, T] (bool: within capacity), pos [k, T]
    (its global slot in the expert, the reference's), slot [k, T] (its
    row among this rank's kept tokens of that expert, < `slots`), gate
    [k, T] (the combine weight: the kept prob, normalized over the kept
    choices where asked; differentiable), aux (scalar f32), slots (the
    rank's rows an expert)."""
    expert: torch.Tensor
    keep: torch.Tensor
    pos: torch.Tensor
    slot: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    slots: int


class _Batch:
    """The batch ranks' exchange of routing's statistics: the groups of
    the batch axes, inner first (a rank's shard index is row-major over
    the axes, as the batch spec splits the rows)."""

    def __init__(self, groups):
        self.groups = [g for g in groups if g is not None]
        self.n = 1
        self.index = 0
        import torch.distributed as dist
        for g in reversed(self.groups):            # outer first
            size = dist.get_world_size(g)
            self.index = self.index * size + dist.get_rank(g)
            self.n *= size

    def gather(self, x):
        """[n, ...] of every batch rank's x, in batch-shard order."""
        out = x[None]
        for g in self.groups:                      # inner first
            out = all_gather(out, g, 0)
        return out

    def sum(self, x):
        for g in self.groups:
            x = all_reduce_sum(x, g)
        return x


_LOCAL = _Batch([])


def route_tokens(probs, k: int, capacity_factor: Optional[float] = None,
                 capacity: Optional[int] = None,
                 normalize: Optional[bool] = None, batch: _Batch = _LOCAL
                 ) -> Routing:
    """Top-k routing of a rank's tokens, probs [T, E] f32, over the
    global batch of `batch` (this rank's tokens are its shard
    `batch.index` of `batch.n`). The capacity is `capacity`, else
    compute_capacity of the global T and `capacity_factor`, else (the
    naive gate) unbounded."""
    if normalize is None:
        normalize = k > 1
    T, E = probs.shape
    dev = probs.device
    t_global = T * batch.n
    if capacity is None:
        capacity = (compute_capacity(t_global, E, capacity_factor)
                    if capacity_factor is not None else t_global)
    with torch.no_grad():
        remaining = probs.detach()
        experts, masks = [], []
        for _ in range(k):
            idx = remaining.argmax(-1)
            mask = F.one_hot(idx, E).to(probs.dtype)
            experts.append(idx)
            masks.append(mask)
            remaining = remaining * (1.0 - mask)
        counts = torch.stack([m.sum(0) for m in masks])          # [k, E]
        every = batch.gather(counts)                              # [n, k, E]
        before = every[:batch.index].sum(0)                       # [k, E]
        total = every.sum(0)
        prior = torch.zeros(E, dtype=probs.dtype, device=dev)
        local_prior = torch.zeros(E, dtype=probs.dtype, device=dev)
        pos, keep, slot = [], [], []
        for i in range(k):
            # the running count along T, the contiguous dim of [E, T]
            run = masks[i].t().cumsum(1) - 1.0                   # [E, T]
            mine = run.gather(0, experts[i][None])[0]
            p_i = mine + before[i].gather(0, experts[i]) + \
                prior.gather(0, experts[i])
            keep_i = p_i < capacity
            # this rank's kept tokens of the expert sit at the start of
            # its run, so a kept token's row is its run count
            slot_i = mine + local_prior.gather(0, experts[i])
            kept_mask = masks[i] * keep_i[:, None].to(probs.dtype)
            local_prior = local_prior + kept_mask.sum(0)
            prior = prior + torch.minimum(
                total[i], (capacity - prior).clamp(min=0.0))
            pos.append(p_i.long())
            keep.append(keep_i)
            slot.append(slot_i.long())
    expert = torch.stack(experts)
    keep_t = torch.stack(keep)
    gate = probs.gather(1, expert.t()).t() * keep_t.to(probs.dtype)
    if normalize:
        gate = gate / gate.sum(0).clamp(min=1e-9)
    # aux = E * sum_e mean(probs)_e * mean(top1)_e over the global T
    me = batch.sum(probs.sum(0)) / t_global
    ce = total[0] / t_global
    aux = E * (me * ce).sum()
    return Routing(expert, keep_t, torch.stack(pos), torch.stack(slot),
                   gate, aux, int(min(capacity, T * k)))


def topk_gating(probs, k: int, capacity: int, normalize: bool = None):
    """GShard top-k routing with per-expert capacity, in the reference's
    dense form: (dispatch [T, E, C] one-hot, combine [T, E, C] weights,
    aux_loss scalar), tokens past an expert's capacity dropped (zero
    rows). `normalize` (default k > 1) renormalizes the combine weights
    over the token's kept choices; k = 1 (Switch) scales by the raw
    gate probability."""
    T, E = probs.shape
    r = route_tokens(probs, k, capacity=capacity, normalize=normalize)
    dispatch = torch.zeros(T * E * capacity, dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    tok = torch.arange(T, device=probs.device)
    for i in range(k):
        flat = (tok * E + r.expert[i]) * capacity + r.pos[i].clamp(
            max=capacity - 1)
        hit = r.keep[i].to(probs.dtype)
        dispatch = dispatch.index_add(0, flat, hit)
        combine = combine.index_add(0, flat, r.gate[i] * hit)
    return (dispatch.view(T, E, capacity), combine.view(T, E, capacity),
            r.aux)


def _experts(xs, up_w, up_b, down_w, down_b):
    """[E, C, D] slot rows through each expert's FFN, each matmul
    rounded before its bias is added, as the reference's einsums."""
    dt = xs.dtype
    h = torch.bmm(xs, up_w.to(dt)) + up_b[:, None, :].to(dt)
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, down_w.to(dt)) + down_b[:, None, :].to(dt)


def _ep_state(layout, n_local: int, n_experts: int):
    """(ep group, first local expert, batch exchange) under `layout`:
    no ep group where the rank holds every expert."""
    if layout is None:
        return None, 0, _LOCAL
    batch = _Batch(layout.batch_groups)
    if n_local == n_experts:
        return None, 0, batch
    if n_local * layout.ep != n_experts:
        raise ValueError(f"moe_ffn: {n_local} local experts of "
                         f"{n_experts} over ep={layout.ep}")
    return layout.ep_group, layout.ep_rank * n_local, batch


def moe_ffn(x, gate_w, up_w, up_b, down_w, down_b, *, gate: str = "switch",
            capacity_factor: float = 1.25, layout=None):
    """MoE FFN on [B, S, D] activations.

    gate_w [D, E]; up_w [E, D, F]; up_b [E, F]; down_w [E, F, D];
    down_b [E, D] (under an expert-parallel layout, this rank's E / ep
    experts of the last four). Returns (y [B, S, D], aux_loss f32
    scalar), over the global batch under a layout."""
    B, S, D = x.shape
    E = gate_w.shape[-1]
    spec = GATES[gate]
    dt = x.dtype
    T = B * S
    xt = x.reshape(T, D)
    ep_group, e0, batch = _ep_state(layout, up_w.shape[0], E)
    probs = torch.softmax(xt.float() @ gate_w.float(), -1)
    r = route_tokens(probs, spec.top_k,
                     capacity_factor if spec.use_capacity else None,
                     batch=batch)
    E_l = up_w.shape[0]
    C_l = r.slots
    rows = E_l * C_l
    local = (r.expert >= e0) & (r.expert < e0 + E_l) & r.keep      # [k, T]
    flat = torch.where(local, (r.expert - e0) * C_l + r.slot,
                       torch.full_like(r.slot, rows))
    # slot -> token (T: the zero row, for a slot no token of this rank
    # fills); the extra slot `rows` takes what no local expert keeps
    tok = torch.arange(T, device=x.device).expand_as(flat)
    slot_tok = torch.full((rows + 1,), T, dtype=torch.long, device=x.device)
    slot_tok.scatter_(0, flat.reshape(-1), tok.reshape(-1))
    # gathers by index_select, whose backward is an index_add (a token's
    # row gathered at most k times, the zero rows' gradients dropped)
    x_in = copy_to(xt, ep_group)
    x_pad = torch.cat([x_in, x_in.new_zeros(1, D)])
    ye = _experts(x_pad.index_select(0, slot_tok[:rows]).view(E_l, C_l, D),
                  up_w, up_b, down_w, down_b)
    ye = torch.cat([ye.reshape(rows, D), ye.new_zeros(1, D)])
    g = copy_to(r.gate, ep_group)
    g = torch.where(local, g, torch.zeros_like(g))
    if not spec.use_capacity:
        # naive: the expert sum (one term) in the activation dtype, then
        # the gate value, cast to it, multiplies
        y = ye.index_select(0, flat[0]) * g[0].to(dt)[:, None]
        y = reduce_from(y.float(), ep_group).to(dt) \
            if ep_group is not None else y
        return y.reshape(B, S, D), r.aux
    y = None
    for i in range(spec.top_k):
        term = g[i].to(dt).float()[:, None] * \
            ye.index_select(0, flat[i]).float()
        y = term if y is None else y + term
    y = reduce_from(y, ep_group)
    return y.to(dt).reshape(B, S, D), r.aux


class MoELayer(nn.Module):
    """nn-level MoE layer (reference MoELayer, moe_layer.py:261): the
    gate and the stacked expert weights, drawn with numpy from `seed`
    (std 0.02, biases zero) on `device` (default: the card).
    forward(x [B, S, D]) -> [B, S, D]; the last load-balancing loss is
    `.aux_loss` — add `layer.aux_loss * coeff` to the train loss like the
    reference's gate loss."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate: str = "switch", capacity_factor: float = 1.25,
                 seed: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        if gate not in GATES:
            raise ValueError(f"unknown gate {gate!r}; options: "
                             f"{sorted(GATES)}")
        from ..device import resolve_device
        dev = resolve_device(device)
        self.gate = gate
        self.capacity_factor = float(capacity_factor)
        self.num_experts = num_experts
        rng = np.random.default_rng(seed)
        E, D, Fh = num_experts, d_model, d_hidden

        def norm(shape):
            a = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                0.02)
            return nn.Parameter(torch.from_numpy(a).to(dev, dtype))

        self.gate_w = norm((D, E))
        self.up_w = norm((E, D, Fh))
        self.up_b = nn.Parameter(torch.zeros(E, Fh, dtype=dtype, device=dev))
        self.down_w = norm((E, Fh, D))
        self.down_b = nn.Parameter(torch.zeros(E, D, dtype=dtype, device=dev))
        self.aux_loss: Optional[torch.Tensor] = None

    def forward(self, x):
        y, aux = moe_ffn(x, self.gate_w, self.up_w, self.up_b, self.down_w,
                         self.down_b, gate=self.gate,
                         capacity_factor=self.capacity_factor)
        self.aux_loss = aux
        return y
