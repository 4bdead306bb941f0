"""Collectives of the sharded train step — the port's counterpart of the
in-trace half of paddle_tpu/parallel/collective.py (`psum` / `pmean`
:62-70), and of the collectives GSPMD inserts for the reference's 3D
step.

Every collective of the step goes through this module, on one of three
routes that `collective_route(group, device)` names from the group's
backend and the tensors' device:

- "nccl": NCCL's own all-gather, reduce-scatter, all-reduce and
  all-to-all (`all_to_all_single`);
- "gloo": gloo's own, on CPU tensors;
- "gloo_cuda_via_all_reduce": a gloo group carrying CUDA tensors, which
  the torch.distributed backend table gives only all-reduce and
  broadcast (two ranks sharing one card, where NCCL refuses). All-gather
  writes the rank's shard at its offset into a buffer of -0.0 and
  all-reduces it: x + (-0.0) is x for every x, so the result is exact.
  Reduce-scatter all-reduces the whole tensor and keeps the rank's
  slice. All-to-all writes the rank's n chunks into row `rank` of an
  [n, n, chunk] buffer of -0.0, all-reduces it and keeps column `rank`:
  exact by the same argument, at n times the bytes.

A group of one rank communicates nothing: every function returns its
input itself.

The differentiable pairs (torch.autograd.Function), by where the step
uses them:

- `gather_from(x, group, dim, grad="sum", dtype=None, out_dtype=None)`:
  all-gather forward, reduce-scatter backward — ZeRO-3's gather of a
  weight, and the sequence-parallel entry of a tensor-parallel region;
  with grad="split" the backward keeps the rank's slice of a gradient
  that every rank of the group holds whole (a weight gathered for work
  done alike on every tensor-parallel rank); with `dtype` the shard is
  cast before it travels (a weight gathered in the matmul's dtype, half
  the bytes of f32);
- `copy_to(x, group, out_dtype=None)`: identity forward, all-reduce
  backward, the entry of a tensor-parallel region;
- `reduce_from(x, group, out_dtype=None)`: all-reduce forward, identity
  backward, after a row-parallel matmul;
- `reduce_scatter_to(x, group, dim, out_dtype=None)`: reduce-scatter
  forward, all-gather backward, after a row-parallel matmul under
  sequence parallelism;
- `all_reduce_sum(x, group)`: all-reduce forward and backward, a sum
  that every rank of the group goes on to use alike (the MoE routing's
  global means over the batch ranks);
- `all_to_all(x, group, split_dim, concat_dim)`: chunk j of x along
  `split_dim` goes to group rank j, and the chunks received are
  concatenated along `concat_dim` in group rank order; the backward is
  the inverse all-to-all (Ulysses' sequence <-> head re-shard,
  parallel/context_parallel.py; `global_scatter`,
  parallel/dist_utils.py).

The pipelined step's stage handoffs go point to point between pp
neighbours through `exchange(slot, outgoing, group, shape, dtype,
device)`: one schedule slot's transfers, each a (src, dst) pair of group
ranks, in one order that every rank of the group passes alike. Each
travels in the dtype it is given (the activation's):
- "nccl": `dist.batch_isend_irecv` over the slot's sends and receives;
- "gloo": gloo's own isend/irecv on CPU tensors, waited together;
- "gloo_cuda_via_all_reduce": one all-reduce over the whole group per
  transfer, the sender contributing the tensor and every other rank
  -0.0 (the all-gather trick above: exact). Every handoff is then a
  rendezvous of the group, so every rank must issue the same transfers
  in the same order, those it neither sends nor receives included,
  or the group deadlocks; the schedule (parallel/pipeline.py) gives
  every rank the same slots.

`out_dtype` casts a pair's result, so that each side of the pair
communicates in the dtype it holds: an f32 partial product is reduced
in f32 and rounded once to `out_dtype`, and its bf16 gradient travels
back in bf16; a bf16 activation travels in bf16 into an f32 region,
and the f32 gradients summed there are reduced in f32 before they are
rounded to the activation's dtype. Every backward reduces in the wider
of the input's and the gradient's dtypes and returns the input's.

The paddle-shaped `all_reduce(tensor, op, group)` surface over paddle
Tensors (reference :198-375) waits for ROADMAP A8.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ROUTES", "collective_route", "group_size", "all_gather",
           "reduce_scatter", "all_reduce", "psum", "pmean", "gather_from",
           "copy_to", "reduce_from", "reduce_scatter_to", "all_reduce_sum",
           "all_to_all", "exchange"]

ROUTES = ("nccl", "gloo", "gloo_cuda_via_all_reduce")


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def collective_route(group=None, device=None) -> str:
    """The route a collective over `group` takes for tensors on `device`
    (default: the card where CUDA is available): "nccl", "gloo" or
    "gloo_cuda_via_all_reduce"."""
    backend = str(dist.get_backend(group))
    if backend == "nccl":
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"collective_route: backend {backend!r} "
                         "(nccl|gloo)")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return ("gloo_cuda_via_all_reduce" if torch.device(device).type == "cuda"
            else "gloo")


def _route(group, device, route: Optional[str]) -> str:
    route = route or collective_route(group, device)
    if route not in ROUTES:
        raise ValueError(f"unknown collective route {route!r} {ROUTES}")
    return route


def all_gather(x: torch.Tensor, group, dim: int = 0,
               route: Optional[str] = None) -> torch.Tensor:
    """The group's shards of `x` concatenated along `dim`, in group rank
    order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    if _route(group, x.device, route) == "gloo_cuda_via_all_reduce":
        buf = torch.full((n,) + tuple(x.shape), -0.0, dtype=x.dtype,
                         device=x.device)
        buf[dist.get_rank(group)] = x
        dist.all_reduce(buf, group=group)
        parts = buf.unbind(0)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0,
                   route: Optional[str] = None) -> torch.Tensor:
    """The sum of the group's `x`, split along `dim` into group-size
    chunks; this rank's chunk (contiguous)."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    if _route(group, x.device, route) == "gloo_cuda_via_all_reduce":
        buf = x.contiguous().clone()
        dist.all_reduce(buf, group=group)
        return buf.chunk(n, dim)[dist.get_rank(group)].contiguous()
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def all_reduce(x: torch.Tensor, group, route: Optional[str] = None
               ) -> torch.Tensor:
    """The sum of the group's `x` (a new tensor; `x` itself for a group
    of one)."""
    if group_size(group) == 1:
        return x
    _route(group, x.device, route)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_to_all_chunks(chunks: torch.Tensor, group,
                       route: Optional[str] = None) -> torch.Tensor:
    """`chunks` [n, ...]: row j goes to group rank j. Returns [n, ...]
    whose row j is what group rank j sent this rank."""
    n = group_size(group)
    if n == 1:
        return chunks
    if chunks.shape[0] != n:
        raise ValueError(f"all_to_all: {chunks.shape[0]} chunks for a "
                         f"group of {n}")
    chunks = chunks.contiguous()
    if _route(group, chunks.device, route) == "gloo_cuda_via_all_reduce":
        buf = torch.full((n,) + tuple(chunks.shape), -0.0,
                         dtype=chunks.dtype, device=chunks.device)
        me = dist.get_rank(group)
        buf[me] = chunks
        dist.all_reduce(buf, group=group)
        return buf[:, me].contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return out


def _all_to_all(x, group, split_dim: int, concat_dim: int,
                route: Optional[str] = None) -> torch.Tensor:
    n = group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    got = _all_to_all_chunks(torch.stack(x.chunk(n, split_dim)), group,
                             route)
    return torch.cat(got.unbind(0), concat_dim)


def exchange(slot, outgoing, group, shape, dtype, device,
             route: Optional[str] = None):
    """One schedule slot's point-to-point handoffs within `group`.
    `slot`: the slot's transfers as (src, dst) group ranks, the same
    list in the same order on every rank of the group; `outgoing`:
    {(src, dst): tensor} for the transfers this rank sends. Every
    transfer carries a tensor of `shape` and `dtype`. Returns
    {(src, dst): tensor} for the transfers this rank receives (new
    tensors on `device`)."""
    me = dist.get_rank(group)
    route = _route(group, device, route)
    got = {}
    if route == "gloo_cuda_via_all_reduce":
        for pair in slot:
            src, dst = pair
            if src == me:
                buf = outgoing[pair].to(dtype).contiguous().clone()
            else:
                buf = torch.full(tuple(shape), -0.0, dtype=dtype,
                                 device=device)
            dist.all_reduce(buf, group=group)
            if dst == me:
                got[pair] = buf
        return got
    ops = []
    for pair in slot:
        src, dst = pair
        if src == me:
            t = outgoing[pair].to(dtype).contiguous()
            peer = dist.get_global_rank(group, dst)
            ops.append((dist.isend, t, peer))
        elif dst == me:
            got[pair] = torch.empty(tuple(shape), dtype=dtype,
                                    device=device)
            peer = dist.get_global_rank(group, src)
            ops.append((dist.irecv, got[pair], peer))
    if not ops:
        return got
    if route == "nccl":
        waits = dist.batch_isend_irecv(
            [dist.P2POp(fn, t, peer, group) for fn, t, peer in ops])
    else:
        waits = [fn(t, peer, group=group) for fn, t, peer in ops]
    for w in waits:
        w.wait()
    return got


def _axis_groups(axis_name, mesh):
    from .mesh import axis_group, get_mesh
    mesh = mesh or get_mesh()
    if mesh is None:
        return []
    names = axis_name if isinstance(axis_name, (tuple, list)) else (axis_name,)
    return [axis_group(mesh, a) for a in names]


def psum(x: torch.Tensor, axis_name, mesh=None) -> torch.Tensor:
    """Sum over the mesh axis `axis_name` (or a tuple of axes) of the
    ambient mesh, as lax.psum over named axes; identity without one."""
    for g in _axis_groups(axis_name, mesh):
        x = all_reduce(x, g)
    return x


def pmean(x: torch.Tensor, axis_name, mesh=None) -> torch.Tensor:
    groups = _axis_groups(axis_name, mesh)
    n = 1
    for g in groups:
        x = all_reduce(x, g)
        n *= group_size(g)
    return x / n if n > 1 else x


# ------------------------------------------------- differentiable pairs
def _cast(x, dtype):
    """x in `dtype` (a view of x where it already is: a Function must
    not return its input itself)."""
    return x.view_as(x) if dtype is None or dtype == x.dtype \
        else x.to(dtype)


def _wide(g, dtype):
    """g in the wider of its dtype and `dtype`."""
    return g.to(torch.promote_types(g.dtype, dtype))


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad, dtype, out_dtype):
        ctx.group, ctx.dim, ctx.grad, ctx.dtype = group, dim, grad, x.dtype
        return _cast(all_gather(_cast(x, dtype), group, dim), out_dtype)

    @staticmethod
    def backward(ctx, g):
        g = _wide(g, ctx.dtype)
        if ctx.grad == "split":
            n, r = group_size(ctx.group), dist.get_rank(ctx.group)
            g = g.chunk(n, ctx.dim)[r].contiguous()
        else:
            g = reduce_scatter(g, ctx.group, ctx.dim)
        return g.to(ctx.dtype), None, None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, out_dtype):
        ctx.group, ctx.dtype = group, x.dtype
        return _cast(x, out_dtype)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_wide(g, ctx.dtype), ctx.group).to(ctx.dtype), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, out_dtype):
        ctx.dtype = x.dtype
        return _cast(all_reduce(x, group), out_dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, out_dtype):
        ctx.group, ctx.dim, ctx.dtype = group, dim, x.dtype
        return _cast(reduce_scatter(x, group, dim), out_dtype)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim).to(ctx.dtype), None, None, \
            None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim, route):
        ctx.args = (group, concat_dim, split_dim, route)
        return _all_to_all(x, group, split_dim, concat_dim, route)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def gather_from(x, group, dim: int, grad: str = "sum", dtype=None,
                out_dtype=None):
    """All-gather along `dim` (of x cast to `dtype`, if given; the
    result cast to `out_dtype`, if given); the backward reduce-scatters
    (grad="sum") or keeps this rank's slice (grad="split")."""
    if grad not in ("sum", "split"):
        raise ValueError(f"gather_from: grad={grad!r} (sum|split)")
    if group_size(group) == 1:
        return x
    return _GatherFrom.apply(x, group, dim, grad, dtype, out_dtype)


def copy_to(x, group, out_dtype=None):
    """Identity forward (x cast to `out_dtype`, if given), all-reduce
    backward."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group,
                                                          out_dtype)


def reduce_from(x, group, out_dtype=None):
    """All-reduce forward (the sum cast to `out_dtype`, if given),
    identity backward."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group,
                                                              out_dtype)


def reduce_scatter_to(x, group, dim: int, out_dtype=None):
    """Reduce-scatter forward along `dim` (cast to `out_dtype`, if
    given), all-gather backward."""
    if group_size(group) == 1:
        return x
    return _ReduceScatterTo.apply(x, group, dim, out_dtype)


def all_reduce_sum(x, group):
    """All-reduce forward and backward: the group's sum, which each rank
    goes on to use alike, so that its gradient is the sum of theirs."""
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def all_to_all(x, group, split_dim: int, concat_dim: int,
               route: Optional[str] = None):
    """Chunk j of x along `split_dim` to group rank j; the chunks this
    rank receives concatenated along `concat_dim` in group rank order.
    The backward is the inverse all-to-all. `x` itself for a group of
    one."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim, route)
