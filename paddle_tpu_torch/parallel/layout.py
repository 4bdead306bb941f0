"""The layout a sharded train step hands its model: which mesh axes each
leaf's stored shard is split over, and the collectives that turn those
shards into what a rank computes with.

The reference states its layout once (PARAM_SPECS pinned by the step,
activation hints in the models) and lets GSPMD insert every collective.
Here each rank runs the model on plain local tensors, so the models
(models/gpt.py, models/llama.py) ask for each weight through `weight`,
which reads the form a leaf is computed with from its pinned spec, and
mark the entry and exit of each tensor-parallel region, as Megatron-LM
writes them out:

- a weight split over fsdp is gathered where a layer uses it (ZeRO-3:
  all-gather forward, reduce-scatter backward, inside the layer's
  checkpoint, so the recompute gathers again);
- a layer leaf whose spec splits its last dim over tp is
  column-parallel (the rank keeps its shard of the output dim), one
  whose spec splits its first dim is row-parallel (its shard of the
  input dim), any other leaf is used whole; `whole(..., part=True)`
  gathers a leaf whole for a rank that computes with a part of it (its
  heads of GPT's fused qkv, whose tp shards straddle the q/k/v blocks;
  a Llama k/v weight whose KV heads tp does not divide);
- a block half enters the tensor-parallel region once, through `enter`
  (identity forward, all-reduce backward; with sequence parallelism,
  the all-gather of the sequence, in the activation's dtype), and its
  column-parallel matmuls (`column_mm`) all read that one entry, so
  autograd sums their input gradients in f32 before the one reduction;
  it leaves through `row_mm` (all-reduce forward; with sequence
  parallelism, the reduce-scatter of the sequence). Both reductions run
  in f32 on what the unsharded matmul accumulates in f32, and round
  once: a sum of separately rounded bf16 partials would move every
  activation and input gradient by up to an ulp, and bf16 training at
  these depths turns such moves into gradient noise at the 1e-3 level
  of cosine.

Gradients follow Megatron's convention: what every rank of a tp group
computes alike (without sequence parallelism, the residual stream, the
norms, the head) carries the whole gradient on each rank; what a rank
computes only a part of carries its part. So after the backward,
`reduce_grads` sums each leaf over the batch axes its shard is not split
over (the rows differ there), and over tp only for the leaves the
forward used on a part of the tensor-parallel work (`tp_partial`: under
sequence parallelism the norms, the post-reduction biases and `wpe`,
which see one sequence shard each). Each rank's loss is the mean over
its own rows; the backward scales it by `loss_scale`, one over the
number of distinct row shards, so the gradient is the global batch's
mean, divided by dp·fsdp (and by tp's sequence shards) once.

The module functions `weight`, `whole`, `enter`, `column_mm` and
`row_mm` take the layout first and are the plain single-device
operations without one; with every axis of size one, the layout's
calls return their inputs themselves, so the sharded step on one rank
runs the very ops of the unsharded one.

Two more axes, read from the mesh (the reference's planner plans
neither; its tests build such meshes by hand):
- 'ep' (expert parallelism, parallel/moe.py): a rank holds its E / ep
  experts of each MoE leaf (`experts`: gathered over every other axis
  its spec names, never over 'ep'); tokens are not split over 'ep', and
  the MoE FFN reduces its partial output over 'ep' itself. Routing
  exchanges its statistics over `batch_groups`, the groups of the batch
  axes the rows are really split over (`split_axes`), inner first;
- 'sp' (context parallelism, parallel/context_parallel.py, GPT's
  `context_parallel` "ring" or "ulysses", over the mesh's own 'sp'
  group): everything outside attention is computed alike on every sp
  rank, so no leaf's gradient is partial over 'sp'; attention enters
  its region through `copy_to`, runs on this rank's sequence chunk and
  leaves through an all-gather whose backward keeps the rank's slice.
Both compute alike what the rows give alike, so neither takes part in
`loss_scale` or `reduce_grads`.

`ServingLayout` is the serving engine's counterpart (inference/
serving.py `mesh=`, the reference's SERVING_PARAM_SPECS under GSPMD):
each rank stores only its tp shard of every leaf, so nothing is
gathered, and the cached forwards (models/gpt.py, models/llama.py)
run the q/k/v/gate/up projections on the rank's stored shard as they
are (kernels/quant_matmul.py `leaf_matmul`: its own output columns,
the int8 kernel on its shard included) and call `row_mm`
for o and down (the rank's partial product over its input rows,
all-reduced over tp: two all-reduces a layer). The embedding is
vocab-parallel (`embed`: each rank looks up the ids its rows hold, -0.0
elsewhere, summed over tp, exact), and the head's logits are gathered
whole (`gather_logits`), so every rank samples the same tokens. A leaf
tp does not divide stays whole on every rank (the reference's
shape-aware degrade) and is used without a collective.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import torch

from .collective import (all_reduce, copy_to, gather_from, psum,
                         reduce_from, reduce_scatter_to)
from .mesh import P, _entry_axes, axis_group, axis_index, axis_names, \
    axis_size

__all__ = ["ShardLayout", "ServingLayout", "current_layout", "use_layout",
           "weight", "whole", "enter", "column_mm", "row_mm", "leaf_form",
           "tp_heads"]

TP = "tp"
EP = "ep"


class ShardLayout:
    """`specs`: {leaf name: the cleaned spec of its stored shard} (the
    step's pins), from which `weight` also reads each leaf's form (the
    planner's checks make tp divide every dim it splits: the heads, the
    FFN width); `sequence_parallel`: activations between blocks live on
    a sequence shard of the tp group (taken only with tp > 1)."""

    def __init__(self, mesh, specs: Dict[str, P], sequence_parallel: bool,
                 batch_axes=("dp", "fsdp"), split_axes=None):
        self.mesh = mesh
        self.specs = dict(specs)
        self.tp = axis_size(mesh, TP)
        self.tp_rank = axis_index(mesh, TP)
        self.tp_group = axis_group(mesh, TP)
        self.sp = bool(sequence_parallel) and self.tp > 1
        self.batch_axes = tuple(batch_axes)
        split = self.batch_axes if split_axes is None else tuple(split_axes)
        self.batch_groups = [axis_group(mesh, a) for a in reversed(split)]
        self.ep = axis_size(mesh, EP)
        self.ep_rank = axis_index(mesh, EP)
        self.ep_group = axis_group(mesh, EP)
        rows = math.prod(axis_size(mesh, a) for a in self.batch_axes)
        self.loss_scale = 1.0 / (rows * (self.tp if self.sp else 1))
        self.world = math.prod(axis_size(mesh, a) for a in axis_names(mesh))
        self.tp_partial = set()

    # ------------------------------------------------------------ weights
    def _spec(self, name: str, layer: bool) -> P:
        spec = self.specs.get(name, P())
        return P(*spec[1:]) if layer else spec

    def _stored_axes(self, name: str):
        return {a for e in self.specs.get(name, P()) for a in _entry_axes(e)}

    def _gather(self, w, spec, skip=None, tp_grad="sum", dtype=None):
        """w gathered over every axis its spec splits it over but `skip`
        ((dim, axis)); the last gather casts to `dtype`, so the earlier
        ones and every backward reduction run in w's own dtype."""
        steps = [(d, axis) for d, entry in enumerate(spec)
                 for axis in reversed(_entry_axes(entry))  # inner first
                 if (d, axis) != skip
                 and axis_group(self.mesh, axis) is not None]
        for i, (d, axis) in enumerate(steps):
            grad = "split" if axis == TP and tp_grad == "split" else "sum"
            w = gather_from(w, axis_group(self.mesh, axis), d, grad,
                            dtype if i == len(steps) - 1 else None)
        return w

    def form(self, name: str, layer: bool = True) -> str:
        """"column", "row" or "whole": how a rank computes with leaf
        `name`, from its spec (a top-level leaf, the embedding or a
        final norm, is always used whole)."""
        return leaf_form(self._spec(name, layer) if layer else P())

    def weight(self, name: str, w, layer: bool = True, dtype=None):
        """Leaf `name`'s local value `w` (one layer's slice of a stacked
        leaf with layer=True) in the form the rank computes with it: its
        stored tp shard of the last dim (column) or the first (row), or
        whole; gathered over every other axis, in `dtype` where it is
        gathered at all."""
        kind = self.form(name, layer)
        if kind == "whole":
            return self.whole(name, w, layer, dtype)
        keep = (w.dim() - 1 if kind == "column" else 0, TP)
        return self._gather(w, self._spec(name, layer), skip=keep,
                            dtype=dtype)

    def whole(self, name: str, w, layer: bool = True, dtype=None,
              part: bool = False):
        """Leaf `name` gathered whole. Used alike on every tp rank, its
        gradient is the rank's whole one: a tp gather keeps the rank's
        slice backward. Used on a part of the tensor-parallel work (a
        sequence shard under sequence parallelism, or part=True: the
        rank computes with a part of the leaf, its heads), its gradient
        is a part: summed over tp."""
        partial = part or self.sp
        if partial and TP not in self._stored_axes(name):
            self.tp_partial.add(name)
        return self._gather(w, self._spec(name, layer),
                            tp_grad="sum" if partial else "split",
                            dtype=dtype)

    def heads(self, n: int):
        """The [first, last) of the n heads (or columns) this tp rank
        owns."""
        return tp_heads(n, self.tp, self.tp_rank)

    def experts(self, name: str, w, dtype=None):
        """A stacked expert leaf's layer slice as this rank stores it
        over 'ep' (its experts), gathered over any other axis its spec
        names."""
        return self._gather(w, self._spec(name, True), skip=(0, EP),
                            dtype=dtype)

    # -------------------------------------------------------- activations
    def enter(self, h):
        """h as the column-parallel matmuls of one block half read it:
        in f32 (its values exact), the whole sequence under sequence
        parallelism (gathered in h's dtype). The backward reduces over
        tp, in f32, the sum of those matmuls' input gradients, and
        rounds it once to h's dtype, as the unsharded matmuls round
        their whole contractions."""
        if self.tp == 1:
            return h
        if self.sp:
            return gather_from(h, self.tp_group, 1, "sum",
                               out_dtype=torch.float32)
        return copy_to(h, self.tp_group, out_dtype=torch.float32)

    def column_mm(self, h, w):
        """h @ w for a column-parallel `w` and h from `enter`: this
        rank's output columns, in w's dtype; h's gradient comes back in
        f32, unrounded."""
        if self.tp == 1:
            return h @ w
        return _MatmulF32Dgrad.apply(h, w)

    def row_mm(self, x, w):
        """x @ w for a row-parallel `w`, reduced over tp (scattered over
        the sequence under sequence parallelism): the rank's partial
        product kept in f32, summed in f32 and rounded once to x's
        dtype, as the unsharded matmul rounds its whole contraction."""
        if self.tp == 1:
            return x @ w
        y = _MatmulF32Out.apply(x, w)
        return (reduce_scatter_to(y, self.tp_group, 1, out_dtype=x.dtype)
                if self.sp else reduce_from(y, self.tp_group,
                                            out_dtype=x.dtype))

    def seq_range(self, S: int):
        """[s0, s1) of the S positions this rank's activations hold."""
        if not self.sp:
            return 0, S
        return self.tp_rank * (S // self.tp), (self.tp_rank + 1) * (S // self.tp)

    def seq_local(self, t, dim: int = 1):
        """This rank's sequence shard of `t` (all of it without sequence
        parallelism)."""
        if not self.sp:
            return t
        return t.chunk(self.tp, dim)[self.tp_rank]

    # ------------------------------------------------------- after backward
    def reduce_grads(self, grads: Dict[str, torch.Tensor]):
        """Each leaf's gradient summed over the batch axes its shard is
        not split over, and over tp where the forward used it on part of
        the tensor-parallel work."""
        out = {}
        for name, g in grads.items():
            stored = self._stored_axes(name)
            axes = [a for a in self.batch_axes if a not in stored]
            if name in self.tp_partial and TP not in stored:
                axes.append(TP)
            for a in axes:
                g = all_reduce(g, axis_group(self.mesh, a))
            out[name] = g
        return out

    def global_loss(self, loss):
        """The global batch's mean loss, the same on every rank, from
        each rank's mean over its rows."""
        if self.world == 1:
            return loss
        total = psum((loss / self.world).reshape(1), axis_names(self.mesh),
                     self.mesh)
        return total.reshape(())


class ServingLayout:
    """The tp layout of a serving engine's cached forward: `mesh`, the
    serving axis `tp_axis`, and `specs`, {leaf name: the cleaned spec of
    the rank's stored shard} (the engine's parameter pins; an int8
    leaf's `<name>_q` carries its weight's spec).

    `row_mm` takes the rank's partial product in the dtype the matmul
    gives it and sums it in f32, rounding once to x's dtype. For an fp
    leaf the partial itself stays f32 (`_mm_f32`), so the layer rounds
    once as the unsharded matmul does; the int8 kernel returns its
    partial in x's dtype (bf16 on the card), so o and down are rounded
    twice there, the kernel's contract unchanged. `collectives` counts
    the all-reduces and all-gathers issued (host calls)."""

    def __init__(self, mesh, specs: Dict[str, P], tp_axis: str = TP):
        self.mesh = mesh
        self.tp_axis = tp_axis
        self.specs = dict(specs)
        self.tp = axis_size(mesh, tp_axis)
        self.tp_rank = axis_index(mesh, tp_axis)
        self.tp_group = axis_group(mesh, tp_axis)
        self.collectives = 0

    def _spec(self, lp, name: str) -> P:
        key = name + "_q" if name + "_q" in lp else name
        return self.specs.get(key, P())

    def form(self, lp, name: str) -> str:
        """"column", "row" or "whole" for a stacked leaf (its spec's
        entries after the layer axis)."""
        return leaf_form(tuple(self._spec(lp, name))[1:], self.tp_axis)

    def split(self, name: str) -> bool:
        """Whether top-level leaf `name`'s first dim (or, for a [K, N]
        head copy, its last) is split over tp."""
        return self.tp_axis in tuple(self.specs.get(name, P()))

    def heads(self, n: int):
        """The [first, last) of n heads this rank owns."""
        return tp_heads(n, self.tp, self.tp_rank)

    def row_mm(self, x, lp, name: str, qmm):
        """x @ a row-parallel leaf, summed over tp in f32 and rounded once
        to x's dtype; a whole leaf's product as it is."""
        from ..kernels.quant_matmul import leaf_matmul
        if self.form(lp, name) != "row" or self.tp == 1:
            return leaf_matmul(x, lp, name, qmm)
        if name + "_q" in lp:
            y = leaf_matmul(x, lp, name, qmm).float()
        else:
            y = _mm_f32(x, lp[name].to(x.dtype))
        self.collectives += 1
        return all_reduce(y, self.tp_group).to(x.dtype)

    def embed(self, wte, tokens, dtype):
        """Rows of the embedding for `tokens` [B, T]: a vocab-parallel
        shard looks up the ids its rows hold (-0.0 elsewhere, so the f32
        sum over tp is exact); a whole table as it is."""
        if not self.split("wte") or self.tp == 1:
            return wte[tokens.long()].to(dtype)
        n = wte.shape[0]
        ids = tokens.long() - self.tp_rank * n
        inside = (ids >= 0) & (ids < n)
        rows = wte[ids.clamp(0, n - 1)].to(dtype).float()
        rows = torch.where(inside[..., None], rows,
                           torch.full_like(rows, -0.0))
        self.collectives += 1
        return all_reduce(rows, self.tp_group).to(dtype)

    def gather_logits(self, logits, name: str):
        """The head's logits whole on every rank: gathered over tp along
        the vocab when head leaf `name` is split."""
        if not self.split(name) or self.tp == 1:
            return logits
        from .collective import all_gather
        self.collectives += 1
        return all_gather(logits.contiguous(), self.tp_group,
                          dim=logits.dim() - 1)


def leaf_form(spec, tp_axis: str = TP) -> str:
    """"column", "row" or "whole": how a rank computes with a leaf whose
    stored spec (after any layer axis) is `spec`: its last dim split
    over tp is column-parallel, its first (of two or more) row-parallel,
    anything else is used whole."""
    spec = tuple(spec)
    if spec and spec[-1] == tp_axis:
        return "column"
    if len(spec) > 1 and spec[0] == tp_axis:
        return "row"
    return "whole"


def tp_heads(n: int, tp: int, rank: int):
    """The [first, last) of n heads (or columns) tp rank `rank` owns."""
    per = n // tp
    return rank * per, (rank + 1) * per


# the model's side: each the plain single-device operation without a
# layout
def weight(layout, name, w, layer=True, dtype=None):
    """Leaf `name` as the rank computes with it (`ShardLayout.weight`),
    in `dtype`; w cast to `dtype` without a layout."""
    if layout is not None:
        w = layout.weight(name, w, layer, dtype)
    return w if dtype is None else w.to(dtype)


def whole(layout, name, w, layer=True, dtype=None, part=False):
    """Leaf `name` whole (`ShardLayout.whole`), in `dtype`."""
    if layout is not None:
        w = layout.whole(name, w, layer, dtype, part)
    return w if dtype is None else w.to(dtype)


def enter(layout, h):
    """h entering a block half's tensor-parallel region."""
    return h if layout is None else layout.enter(h)


def column_mm(layout, h, w):
    """h @ w for a column-parallel weight, h from `enter`."""
    return h @ w if layout is None else layout.column_mm(h, w)


def row_mm(layout, x, w):
    """x @ w for a row-parallel weight, reduced over tp."""
    return x @ w if layout is None else layout.row_mm(x, w)


def _mm_f32(a, b):
    """a @ b of low-precision operands, the product returned in f32,
    unrounded: on the card one tensor-core GEMM with an f32 output
    (aten's mm.dtype), as the low-precision GEMM accumulates before it
    rounds; elsewhere (the CPU has no such kernel) the f32 product of
    the upcast operands, the same exact products summed in f32."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and a.dtype != torch.float32:
        out = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        out = a2.float() @ b.float()
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _mm_dw(x, g):
    """The weight gradient of x @ w as autograd forms it: x's rows
    flattened, transposed, times g's."""
    return x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])


class _MatmulF32Out(torch.autograd.Function):
    """x @ w with the product kept in f32 (`_mm_f32`); the backward is
    the low-precision matmul's own: both gradients in x's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.t(), _mm_dw(x, g)


class _MatmulF32Dgrad(torch.autograd.Function):
    """x32.to(w.dtype) @ w (x32 holds w.dtype values), whose input
    gradient comes back in f32, unrounded, for autograd to sum with the
    block half's other projections and a reduction over tp to round
    once; the weight gradient is the matmul's own."""

    @staticmethod
    def forward(ctx, x32, w):
        x = x32.to(w.dtype)
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _mm_f32(g, w.t()), _mm_dw(x, g)


_state = threading.local()


def current_layout() -> Optional[ShardLayout]:
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


class use_layout:
    """Run a step's forward and backward under `layout` (the sharded
    step enters it around the family's train step)."""

    def __init__(self, layout: ShardLayout):
        self.layout = layout

    def __enter__(self):
        if not hasattr(_state, "stack"):
            _state.stack = []
        _state.stack.append(self.layout)
        return self.layout

    def __exit__(self, *exc):
        _state.stack.pop()
        return False
