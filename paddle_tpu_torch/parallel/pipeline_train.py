"""The pipelined pp>1 train step (dp×fsdp×tp×pp) for the GPT and Llama
families: the port's counterpart of paddle_tpu/parallel/pipeline_train.py
(`_vocab_parallel_embed` :91, `_vocab_parallel_ce` :105,
`_run_pipeline` :127, the GPT stage :195-286, the Llama stage :290-353,
`_family_of` :356, `make_pp_step_fn` :368).

The reference runs the whole step as one full-manual shard_map: the
stacked layer axis is cut over the 'pp' mesh axis, microbatches
circulate between stages on a scan of ppermute hops, and autodiff
replays that scan in reverse. Here each rank is one process that holds
its stage's chunk of every stacked leaf ([L/pp, ...], cut over 'pp' on
dim 0 by the plan's specs) and drives the 1F1B schedule of
parallel/pipeline.py on the host, as the reference analog does
(fleet/meta_parallel/pipeline_parallel.py:188):

- a stage's forward of a microbatch keeps its autograd graph; its
  output travels to the next stage detached, in the activation's
  dtype (parallel/collective.py `exchange`, on the route
  `collective_route` names for the pp group);
- the next stage takes it as a leaf that requires its gradient; the
  last stage adds the final norm, the head and the loss;
- a backward runs `torch.autograd.backward` on the stage's output with
  the output gradient it received (on the last stage, on the loss), and
  the gradient of the stage's input leaf travels back;
- the parameters' gradients accumulate over the microbatches in f32.

Inside a stage, each layer is split at the ZeRO-3 seam: `gather_fn`
gathers the layer's fsdp shards (in the matmul's dtype), `compute_fn` is
the family's block (models/gpt.py `_block`, models/llama.py `_block`)
under a ShardLayout whose specs keep only the tensor-parallel splits, so
the block's `weight()` calls give the column and row shards and its tp
regions enter and leave as in the 3D step. With cfg.remat each layer
runs under torch.utils.checkpoint (GPT's remat policies as in
`_apply_stack`), so the backward gathers again; the layout rides the
checkpoint as an argument. `overlap` is recorded and changes nothing:
the reference's overlap double-buffers the gather through the scan
carry for XLA's scheduler, and an eager host-driven stage has no such
scheduler to give the slack to.

The embedding and the tied head are vocab-parallel over tp: each rank
holds V/tp rows of `wte`; the embedding gathers the rows it holds and
sums over tp, and the cross entropy takes the global max, then the
logsumexp and the target's logit summed over tp, in f32. At tp = 1 both
are the plain embedding and the plain f32 cross entropy. The reference
reaches no Pallas CE on this path, and neither does the port: the loss
is stock torch.

The loss is the reference's: the microbatches' mean CE on the last
stage, divided by dp·fsdp·tp, summed over every mesh axis, so every
rank returns the global batch's mean. Each microbatch's backward is
seeded with 1 / (m·dp·fsdp). After the backward each leaf's gradient is
summed over the mesh axes its spec does not name, by the port's tp
convention (parallel/layout.py): over dp and fsdp where its shard is
not split, over pp for the leaves no stage chunk holds alone (`wte`,
used by the embedding on stage 0 and the head on the last; the final
norm; GPT's `wpe`), and over tp only for the leaves a rank used on a
part of the tp work. Then AdamW (models/gpt.py `apply_adamw`, the fused
kernel where the registry says) updates each rank's shards in place.
"""
from __future__ import annotations

import functools
import math
import types
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from .collective import (all_gather, all_reduce, collective_route,
                         exchange, gather_from, psum, reduce_from)
from .layout import ShardLayout, column_mm, enter
from .mesh import (P, _entry_axes, axis_group, axis_index, axis_names,
                   axis_size, mesh_device, remap_spec_axes, sharding_for)
from .pipeline import schedule_stats, timeline

__all__ = ["make_pp_step_fn", "PipelinedStep"]

FSDP, PP = "fsdp", "pp"


def _spec_axes(spec) -> set:
    return {a for e in spec for a in _entry_axes(e)}


# ---------------------------------------------------------------- helpers
def _gather_fsdp(w, spec, mesh, dtype=None):
    """w gathered over fsdp on the dim its spec splits over fsdp (ZeRO-3:
    reduce-scatter backward), cast to `dtype` before it travels."""
    group = axis_group(mesh, FSDP)
    for d, entry in enumerate(spec):
        if FSDP in _entry_axes(entry) and group is not None:
            return gather_from(w, group, d, "sum", dtype)
    return w


def _vocab_parallel_embed(wte, tokens, group, v0: int):
    """Embedding rows of `tokens` from a vocab shard `wte` [V/tp, D]
    holding rows [v0, v0 + V/tp): the rows this rank holds, zeros
    elsewhere, summed over tp (the backward scatters the whole
    cotangent into each rank's rows). The plain embedding without a
    group."""
    if group is None:
        return F.embedding(tokens.long(), wte)
    v_loc = wte.shape[0]
    idx = tokens.long() - v0
    ok = (idx >= 0) & (idx < v_loc)
    x = F.embedding(idx.clamp(0, v_loc - 1), wte)
    return reduce_from(x.masked_fill(~ok[..., None], 0.0), group)


def _vocab_parallel_ce(logits, targets, group, v0: int):
    """models/losses.fused_softmax_ce over vocab-sharded logits
    [..., V/tp] (columns [v0, v0 + V/tp)), in f32: the global max (no
    gradient: subtracting a constant leaves the math exact), then the
    logsumexp and the target's logit, each summed over tp. Every tp rank
    holds the same loss; each backpropagates its own copy (the sums'
    backward is the identity). The mean over all positions; the plain
    f32 cross entropy without a group."""
    lf = logits.float()
    if group is None:
        tgt = lf.gather(-1, targets[..., None].long())[..., 0]
        return (torch.logsumexp(lf, -1) - tgt).mean()
    v_loc = lf.shape[-1]
    with torch.no_grad():
        mx = all_gather(lf.amax(-1)[None], group, 0).amax(0)
    se = reduce_from(torch.exp(lf - mx[..., None]).sum(-1), group)
    lse = mx + torch.log(se)
    tl = targets.long() - v0
    ok = (tl >= 0) & (tl < v_loc)
    g = lf.gather(-1, tl.clamp(0, v_loc - 1)[..., None])[..., 0]
    tgt = reduce_from(g.masked_fill(~ok, 0.0), group)
    return (lse - tgt).mean()


def _layer(lp, h, gather_fn, compute_fn):
    return compute_fn(gather_fn(lp), h)


def _run_pipeline(stacked, x, gather_fn, compute_fn, remat: bool,
                  context_fn=noop_context_fn):
    """One stage's chunk of layers over one microbatch's activations:
    `stacked` holds the stage's [L/pp, ...] leaves; each layer gathers
    its fsdp shards (`gather_fn`), then runs its block (`compute_fn`),
    under a checkpoint with remat, so the backward gathers again. The
    layer slices are taken here, per microbatch, so that each
    microbatch's graph owns its own views."""
    n = next(iter(stacked.values())).shape[0]
    for layer in range(n):
        lp = {k: v[layer] for k, v in stacked.items()}
        if remat:
            x = checkpoint(_layer, lp, x, gather_fn, compute_fn,
                           use_reentrant=False, context_fn=context_fn)
        else:
            x = _layer(lp, x, gather_fn, compute_fn)
    return x


# ----------------------------------------------------------- the families
class _Family:
    """A family's stage pieces over one step's context: `first` (stage
    0: the embedding), the per-layer `gather` and `compute`, and `last`
    (the last stage: final norm, head, loss)."""

    def __init__(self, ctx, params, seq: int):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.params = params
        self.seq = seq

    def gather(self, lp):
        """The layer's fsdp gathers, in the activation dtype; leaves
        without an fsdp split pass through."""
        ctx = self.ctx
        return {k: _gather_fsdp(w, ctx.specs[k][1:], ctx.mesh,
                                self.cfg.dtype)
                for k, w in lp.items()}

    def wte(self):
        """This rank's vocab shard of `wte` [V/tp, D], gathered over
        fsdp, in f32."""
        return _gather_fsdp(self.params["wte"], self.ctx.specs["wte"],
                            self.ctx.mesh)

    def head_loss(self, y, tgt):
        """Vocab-parallel tied head and cross entropy of the normed
        output y: one tp entry, the rank's logit columns, the f32
        reductions of layout.column_mm."""
        ctx = self.ctx
        logits = column_mm(ctx.layout, enter(ctx.layout, y),
                           self.wte().to(y.dtype).t())
        return _vocab_parallel_ce(logits, tgt, ctx.vocab_group, ctx.v0)


def _gpt_block_x(params_l, x, cfg, layout):
    """A dense GPT block's x (models/gpt.py `_block` also returns the MoE
    aux, None here: the pp step refuses MoE)."""
    from ..models import gpt
    return gpt._block(params_l, x, cfg, layout)[0]


class _GPTStage(_Family):
    """reference :195-286: the fused qkv's head columns cut per q/k/v
    (models/gpt.py `_local_qkv`), the tied vocab-parallel head."""

    def __init__(self, ctx, params, seq):
        super().__init__(ctx, params, seq)
        from ..models import gpt
        from ..models.remat import POLICIES
        self.keys = gpt._BLOCK_KEYS_DENSE
        cfg = self.cfg
        self.remat = cfg.remat and cfg.remat_policy != "all_but_mlp"
        self.context_fn = POLICIES.get(cfg.remat_policy, noop_context_fn)
        self.compute = functools.partial(_gpt_block_x, cfg=cfg,
                                         layout=ctx.layout)

    def first(self, tok):
        ctx, cfg = self.ctx, self.cfg
        wpe = _gather_fsdp(self.params["wpe"], ctx.specs["wpe"], ctx.mesh)
        x = _vocab_parallel_embed(self.wte(), tok, ctx.vocab_group,
                                  ctx.v0).to(cfg.dtype)
        return x + wpe[:self.seq][None].to(cfg.dtype)

    def last(self, h, tgt):
        from ..models.gpt import _ln
        p = self.params
        y = _ln(h, p["ln_f_scale"], p["ln_f_bias"], self.cfg.layer_norm_eps)
        return self.head_loss(y, tgt)


class _LlamaStage(_Family):
    """reference :290-353: q/k/v column blocks, GQA at KV/tp heads a
    rank (models/llama.py `_kv_heads`), RoPE tables per stage."""

    def __init__(self, ctx, params, seq):
        super().__init__(ctx, params, seq)
        from ..models import llama
        cfg = self.cfg
        self.keys = llama._BLOCK_KEYS
        self.remat = bool(cfg.remat)
        self.context_fn = noop_context_fn
        cos, sin = llama._rope_tables(seq, cfg.head_dim, cfg.rope_theta,
                                      ctx.device)
        self.compute = functools.partial(llama._block, cfg=cfg, cos=cos,
                                         sin=sin, layout=ctx.layout)

    def first(self, tok):
        ctx = self.ctx
        return _vocab_parallel_embed(self.wte(), tok, ctx.vocab_group,
                                     ctx.v0).to(self.cfg.dtype)

    def last(self, h, tgt):
        from ..models.llama import _rmsnorm
        y = _rmsnorm(h, self.params["norm_f"], self.cfg.rms_eps)
        return self.head_loss(y, tgt)


_STAGES = {"gpt": _GPTStage, "llama": _LlamaStage}


def _family_of(cfg) -> str:
    name = type(cfg).__name__
    if "Llama" in name or hasattr(cfg, "num_kv_heads"):
        return "llama"
    if "GPT" in name or hasattr(cfg, "pipeline_microbatches"):
        return "gpt"
    raise NotImplementedError(
        f"pipeline-parallel training supports the gpt/llama stacked-"
        f"scan families; got config {name}")


# ------------------------------------------------------- the step builder
class PipelinedStep:
    """The facade-contract pp>1 step: `(params, opt_state, batch) ->
    (loss, params, opt_state)` on this rank's local shards and local
    batch rows, plus a trailing bubble fraction (a 0-d tensor) with
    `with_stats`: the schedule's, 1 - busy slots / (stages x slots) of
    the 1F1B timeline every rank runs (`schedule_stats`), which (pp, m)
    fix; the time the ranks wait at handoffs is not in it.
    `loss_and_grads(params, batch)` gives the loss and the reduced
    gradient shards without an update. `route` (None: the pp
    group's `collective_route`) names the stage handoffs' route;
    `leaf_specs` ({leaf: cleaned spec}, None: the plan's on the mesh)
    the split of each local leaf."""

    def __init__(self, cfg, plan, mesh, family, lr, with_stats, overlap,
                 adamw_kw):
        self.cfg, self.plan, self.mesh = cfg, plan, mesh
        self.family = family
        self.lr, self.adamw_kw = lr, dict(adamw_kw)
        self.with_stats = bool(with_stats)
        self.overlap = bool(overlap)
        self.microbatches = int(plan.microbatches)
        self.pp = axis_size(mesh, PP)
        self.stage = axis_index(mesh, PP)
        self.pp_group = axis_group(mesh, PP)
        self.device = mesh_device(mesh)
        self.route = None
        self.leaf_specs = None
        self.slots = timeline(self.pp, self.microbatches)
        st = schedule_stats(self.pp, self.microbatches)
        slots = st["stages"] * st["ticks"]
        self.bubble = (slots - st["busy"]) / slots
        names = axis_names(mesh)
        self.n_grid = math.prod(axis_size(mesh, a) for a in names
                                if a != PP)
        self.batch_axes = tuple(plan.batch_axes)
        rows = math.prod(axis_size(mesh, a) for a in self.batch_axes)
        self.loss_scale = 1.0 / (self.microbatches * rows)

    # ----------------------------------------------------------- context
    def _context(self, params):
        """The step's shared state: each leaf's stored spec
        (`leaf_specs`, the pins of the facade's step; else the plan's
        specs on the mesh), the compute layout (specs without fsdp: the
        gathers run in `_Family.gather`), the vocab shard."""
        mesh, plan = self.mesh, self.plan
        table = plan.specs or {}
        ctx = types.SimpleNamespace(cfg=self.cfg, mesh=mesh,
                                    device=self.device)
        ctx.specs = dict(self.leaf_specs or {
            k: sharding_for(table.get(k, P()), mesh).spec for k in params})
        keep = {a: a for a in axis_names(mesh) if a != FSDP}
        ctx.layout = ShardLayout(
            mesh, {k: remap_spec_axes(s, keep) for k, s in ctx.specs.items()},
            sequence_parallel=False, batch_axes=self.batch_axes)
        split = "tp" in _spec_axes(ctx.specs["wte"][:1])
        ctx.vocab_group = ctx.layout.tp_group if split else None
        ctx.v0 = (ctx.layout.tp_rank * params["wte"].shape[0]) if split \
            else 0
        return ctx

    # ------------------------------------------------------------- calls
    def loss_and_grads(self, params, batch):
        """(global loss, this rank's reduced gradient shards)."""
        loss, grads, _ = self._pipeline(params, batch)
        return loss, grads

    def __call__(self, params, opt_state, batch):
        from ..models.gpt import apply_adamw
        loss, grads, bubble = self._pipeline(params, batch)
        apply_adamw(grads, params, opt_state, self.lr, **self.adamw_kw)
        out = (loss, params, opt_state)
        return out + (bubble,) if self.with_stats else out

    def _pipeline(self, params, batch):
        toks = batch["tokens"] if isinstance(batch, dict) else batch
        m = self.microbatches
        if toks.shape[0] % m:
            raise ValueError(
                f"per-shard batch {toks.shape[0]} is not divisible by "
                f"microbatches={m} (plan {self.plan.name})")
        ctx = self._context(params)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        inp, tgt = toks[:, :-1], toks[:, 1:]
        seq, mb = inp.shape[1], toks.shape[0] // m
        stage = _STAGES[self.family](ctx, leaves, seq)
        stacked = {k: leaves[k] for k in stage.keys if k in leaves}
        gather = stage.gather
        run = functools.partial(_run_pipeline, gather_fn=gather,
                                compute_fn=stage.compute,
                                remat=stage.remat,
                                context_fn=stage.context_fn)
        ce_sum = self._schedule(
            stage, stacked, run,
            [inp[i * mb:(i + 1) * mb] for i in range(m)],
            [tgt[i * mb:(i + 1) * mb] for i in range(m)],
            (mb, seq, self.cfg.hidden_size))
        grads = self._reduce_grads(ctx, {
            k: v.grad if v.grad is not None else torch.zeros_like(v)
            for k, v in leaves.items()})
        # the reference's loss: the last stage's mean CE / (dp·fsdp·tp),
        # summed over every axis
        last = self.stage == self.pp - 1
        part = (ce_sum / m if last else torch.zeros(
            (), dtype=torch.float32, device=self.device)) / self.n_grid
        loss = psum(part.reshape(1), axis_names(self.mesh),
                    self.mesh).reshape(())
        bubble = torch.tensor(self.bubble, dtype=torch.float64) \
            if self.with_stats else None
        return loss, grads, bubble

    def _schedule(self, stage, stacked, run, inp_mbs, tgt_mbs, shape):
        """The 1F1B slots: this rank's work in each, then the slot's
        handoffs. Returns the sum of the microbatches' losses on the
        last stage."""
        s, pp = self.stage, self.pp
        route = self.route or collective_route(self.pp_group, self.device)
        saved, inbox = {}, {}
        ce_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for slot in self.slots:
            outgoing = {}
            work = slot.get(s)
            if work is not None:
                kind, i = work
                if kind == "F":
                    x_in = None
                    if s == 0:
                        x = stage.first(inp_mbs[i])
                    else:
                        x = x_in = inbox.pop(("F", i)).requires_grad_()
                    y = run(stacked, x)
                    if s == pp - 1:
                        y = stage.last(y, tgt_mbs[i])
                        ce_sum = ce_sum + y.detach()
                    else:
                        outgoing[(s, s + 1)] = y.detach()
                    saved[i] = (x_in, y)
                else:
                    x_in, y = saved.pop(i)
                    if s == pp - 1:
                        torch.autograd.backward(y * self.loss_scale)
                    else:
                        torch.autograd.backward(y, inbox.pop(("B", i)))
                    if s > 0:
                        outgoing[(s, s - 1)] = x_in.grad
            pairs = ([(t, t + 1) for t, (k, _) in sorted(slot.items())
                      if k == "F" and t < pp - 1]
                     + [(t, t - 1) for t, (k, _) in sorted(slot.items())
                        if k == "B" and t > 0])
            if pairs:
                got = exchange(pairs, outgoing, self.pp_group, shape,
                               self.cfg.dtype, self.device, route)
                for (src, dst), t in got.items():
                    inbox[("F" if dst > src else "B", slot[src][1])] = t
        return ce_sum

    def _reduce_grads(self, ctx, grads: Dict[str, torch.Tensor]):
        """Each leaf's gradient summed over the mesh axes its spec does
        not name: the batch axes its shard is not split over, pp for
        the leaves no stage chunk holds alone, and tp where the block
        used the leaf on a part of the tp work."""
        out = {}
        for name, g in grads.items():
            stored = _spec_axes(ctx.specs[name])
            axes = [a for a in self.batch_axes if a not in stored]
            if name in ctx.layout.tp_partial and "tp" not in stored:
                axes.append("tp")
            if PP not in stored:
                axes.append(PP)
            for a in axes:
                g = all_reduce(g, axis_group(self.mesh, a))
            out[name] = g
        return out


def make_pp_step_fn(cfg, plan, mesh, lr: float = 3e-4,
                    with_stats: bool = False, overlap=None, **adamw_kw):
    """The pp>1 step for (cfg, plan) on `mesh` (reference :368), with
    the reference's refusals and messages. `overlap` (None: the plan's)
    is recorded and changes nothing (see the module docstring)."""
    family = _family_of(cfg)
    if overlap is None:
        overlap = bool(getattr(plan, "overlap", False))
    pp = int(plan.axes.get("pp", 1))
    if pp <= 1:
        raise ValueError("make_pp_step_fn needs a plan with a pp>1 axis"
                         " — use the GSPMD 3D step otherwise")
    tp_axis = plan.mapping.get("mp", "tp")
    tp = int(plan.axes.get(tp_axis, 1))
    microbatches = int(getattr(plan.plan, "microbatches", 0) or 0)
    if microbatches < 2:
        raise ValueError(
            f"plan {plan.name} carries microbatches={microbatches}; the "
            "pipelined step needs >=2 (plan_train picks them for pp>1 "
            "plans)")
    names = axis_names(mesh)
    missing = [a for a in ("dp", "fsdp", tp_axis, "pp") if a not in names]
    if missing:
        raise ValueError(
            f"the pp train step needs all of dp/fsdp/{tp_axis}/pp as "
            f"mesh axes (degree 1 included); mesh "
            f"{dict(zip(names, mesh.shape))} lacks {missing}")
    if getattr(cfg, "num_experts", 0):
        raise NotImplementedError(
            "MoE under pipeline parallelism is not implemented (the "
            "expert dispatch needs its own manual partitioning)")
    if getattr(cfg, "context_parallel", "none") not in ("none",):
        raise NotImplementedError(
            "context parallelism does not compose with the manual pp "
            "step yet")
    if family == "llama" and tp > 1 and cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide num_kv_heads={cfg.num_kv_heads} "
            "(the manual GQA split holds KV/tp kv-heads per rank)")
    return PipelinedStep(cfg, plan, mesh, family, lr, with_stats, overlap,
                         adamw_kw)
