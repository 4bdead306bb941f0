"""The model objects over the functional cores — `GPTModel` (`forward`,
`loss`) and `LlamaModel` (`forward`), each with `generate` over its
family's cached serving engine, on one leaf-holding base,
`FacadeModel` — and `make_train_step`, which makes the train-step
callable.

Counterpart of paddle_tpu/models/facade.py (`resolve_plan_step` :25,
`plan_step_cell` :62, `make_train_step` :95, `_ShardedTrainStep`
:186-475 with its `rebuild` :430 and
`_PipelineTrainStep` :478-512 folded in, `FacadeModel` :515
with its `generate`), paddle_tpu/models/gpt.py
`GPTModel` (`forward` :650, `loss` :658) and paddle_tpu/models/llama.py
`LlamaModel` (:350-367). The leaves live on the module: floating leaves
as frozen nn.Parameters, integer leaves (a quantized tree's int8 pairs)
as buffers, under the reference's leaf names.

Observability (the reference's :140-145, :386-420, :462): every build
opens the `facade.make_train_step` span and counts
`facade_train_step_builds`; `rebuild` counts `facade_train_step_rebuilds`;
a `torch.OutOfMemoryError` inside a sharded step's call writes the
`oom_forensics` flight dump (the plan's `train_memory_ledger` and a
census of the step's argument tensors beside what else the allocator
holds), counts `train.oom_forensics` and re-raises; a pipelined step
publishes its `train.bubble_fraction` at its first call. The reference's
`train.compile.wall_ms` and `train.compile.executables` gauges time an
XLA compile at the first call, which an eager step does not have, so
the port does not publish them.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..parallel.collective import all_gather
from ..parallel.layout import ShardLayout, use_layout
from ..parallel.mesh import (P, _entry_axes, axis_group, axis_names,
                             axis_size, leaf_path_name, remap_specs,
                             sharding_for, use_mesh)
from .gpt import gpt_forward, gpt_loss, init_gpt_params
from .llama import init_llama_params, llama_forward

__all__ = ["FacadeModel", "GPTModel", "LlamaModel", "make_train_step",
           "resolve_plan_step", "plan_step_cell"]


def _plan_pp(plan) -> int:
    """The plan's pipeline degree (1 when absent or 3D)."""
    try:
        return int(plan.axes.get("pp", 1))
    except AttributeError:
        return 1


def resolve_plan_step(step_fn, cfg=None, mesh=None, plan=None,
                      with_stats=False, overlap=None, **step_kw):
    """The callable a plan runs (reference :25). pp=1 (or no plan):
    `step_fn` with `cfg` and the optimizer keywords bound. pp>1: the
    family train step cannot run as it is (its layer loop needs every
    layer, and the plan cuts the stacked layer axis over 'pp'), so the
    callable is parallel/pipeline_train.py's pipelined step for (cfg,
    plan, mesh), with the same (params, opt, batch) -> (loss, params,
    opt) contract (plus the bubble fraction with `with_stats`), the
    optimizer keywords forwarded to the shared apply_adamw."""
    if _plan_pp(plan) > 1:
        if mesh is None:
            raise ValueError("a pp>1 plan needs mesh= (build it with "
                             "plan.build_mesh())")
        from ..parallel.pipeline_train import make_pp_step_fn
        return make_pp_step_fn(cfg, plan, mesh, with_stats=with_stats,
                               overlap=overlap, **step_kw)
    if cfg is not None:
        step_kw = dict(step_kw, cfg=cfg)
    return functools.partial(step_fn, **step_kw) if step_kw else step_fn


class _PlanStepCell:
    """The resolution cell of a plan's step (reference `plan_step_cell`
    :62): `fn` is the CURRENT resolved step (resolve_plan_step: the
    pipelined step under a pp>1 plan, whose leaf specs the facade's
    step sets); `rebuild(mesh, plan)` resolves it again for another
    mesh and plan (a pp step holds its stage grid; a 3D one nothing of
    the mesh). The reference hands a wrapper a fresh forwarding callable
    at each rebuild because jax's tracing cache keys on function
    identity; an eager step has no such cache, so the cell is re-resolved
    in place and every caller keeps its callable. A wrapper of the step
    (the resilient guard) calls `cell.fn` and marks itself with
    `wrapper._plan_cell = cell`, which make_train_step reads."""

    def __init__(self, step_fn, cfg, mesh, plan, step_kw):
        self._step_fn, self._cfg, self._step_kw = step_fn, cfg, step_kw
        self.fn = None
        self.rebuild(mesh, plan)

    def rebuild(self, mesh, plan) -> None:
        self.fn = resolve_plan_step(self._step_fn, cfg=self._cfg,
                                    mesh=mesh, plan=plan, **self._step_kw)


def plan_step_cell(step_fn, cfg=None, mesh=None, plan=None, **step_kw):
    """A _PlanStepCell over resolve_plan_step(step_fn, cfg, mesh, plan,
    **step_kw)."""
    return _PlanStepCell(step_fn, cfg, mesh, plan, step_kw)


def make_train_step(step_fn, cfg=None, mesh=None, plan=None, overlap=None,
                    **step_kw):
    """The step callable `(params, opt_state, batch) -> (loss, params,
    opt_state)`: `step_fn` (the train_step of models/gpt.py or
    models/llama.py) with `cfg` and the optimizer keywords bound.
    PyTorch runs eagerly, so there is nothing to jit; the reference's
    buffer donation is the step's in-place update.

    With `mesh` (parallel.mesh.build_mesh, or `plan.build_mesh()`) and
    `plan` (parallel.planner.plan_train's TrainPlan), the step is the
    planner-driven `_ShardedTrainStep`: each rank holds the shards the
    plan's specs give it and runs on them, dp×fsdp×tp, or the 1F1B
    pipelined step (parallel/pipeline_train.py) for a pp>1 plan, which
    needs the mesh. A `step_fn` marked `_plan_cell` (the resilient
    guard over plan_step_cell) is run as it is over its cell, extra
    arguments and outputs passing through. `overlap` (None: the plan's
    own field) is recorded and changes nothing: the reference's overlap
    is a set of XLA compiler options for the TPU (reference :234-249)
    and, under pp, a gather prefetch through its scan carry for XLA's
    scheduler; neither has a counterpart in an eager step."""
    from ..profiler import RecordEvent, monitor
    if overlap is None:
        overlap = bool(getattr(plan, "overlap", False))
    with RecordEvent("facade.make_train_step"):
        monitor.counter("facade_train_step_builds").add()
        cell = getattr(step_fn, "_plan_cell", None)
        if cell is not None:
            if mesh is None:
                return step_fn
            return _ShardedTrainStep(cell, mesh, plan, cfg=cfg,
                                     overlap=overlap, wrapper=step_fn)
        cell = plan_step_cell(step_fn, cfg=cfg, mesh=mesh, plan=plan,
                              overlap=overlap, **step_kw)
        if mesh is None:
            return cell.fn
        return _ShardedTrainStep(cell, mesh, plan, cfg=cfg, overlap=overlap)


def mesh_plan(cfg, mesh):
    """The TrainPlan of a hand-built mesh (one with an 'ep' or 'sp'
    axis, which plan_train never emits): its own axes, the batch over
    whichever of dp and fsdp it has, and the family's PARAM_SPECS
    remapped onto it ('mp' -> 'tp', 'fsdp' and 'ep' kept, 'pp' dropped),
    each leaf then cleaned shape-aware by its pin."""
    from ..parallel.planner import TrainPlan, _resolve_param_specs
    table = _resolve_param_specs(cfg) or {}
    names = axis_names(mesh)
    mapping = {"fsdp": "fsdp", "mp": "tp", "ep": "ep"}
    return TrainPlan(
        axes={a: axis_size(mesh, a) for a in names}, mapping=mapping,
        batch_axes=tuple(a for a in ("dp", "fsdp") if a in names),
        plan=None, specs=remap_specs(table, mapping))


def _map_tree(fn, tree, path=()):
    """fn(path, leaf) over a nested dict of leaves, keeping its shape."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _shape_of(path, leaf):
    """A leaf's full shape: the leaf's own, or the leaf is the shape."""
    return tuple(leaf) if isinstance(leaf, (tuple, list)) \
        else tuple(leaf.shape)


class _ShardedTrainStep:
    """The planner-driven train step (reference :186-475), dp×fsdp×tp or,
    under a pp>1 plan, pipelined.

    Pins come from the full shapes (`in_pins`: params, opt state,
    batch; `out_pins`: loss, params, opt state), as the reference's
    in/out shardings do:
    - every params and opt leaf pins by its leaf name through
      `plan.specs` (Adam's m and v mirror the param tree, so their
      moments shard like their params; unknown names, as opt["step"],
      replicate), shape-aware per parallel.mesh.sharding_for; under pp
      a stacked leaf's pin cuts its layer axis over 'pp';
    - the batch's leading dim splits over the plan's `batch_axes`
      (dp×fsdp), degrading to replicated when it does not divide.

    The reference's pp>1 flavor, `_PipelineTrainStep` (:478-512), is
    this class under a pp>1 plan: whether a call pipelines is read from
    the current plan, so `rebuild` can cross between 3D and pp. Its
    `bubble_fraction` is the first call's (the 1F1B schedule's, which
    the plan's (pp, m) fix), also published as the
    `train.bubble_fraction` gauge.

    Leaves are plain local tensors beside that pin table. `shard_args`
    turns full trees (numpy or tensors) into this rank's shards; the
    first call shards the trees it is given and returns the local ones,
    later calls take the local trees back and a full batch.
    `adopt_shapes` pins the state from its full shapes without a call
    (for local trees that came from elsewhere, as a checkpoint restored
    onto this plan); the next call then takes local trees. A 3D call
    runs the family step under a `ShardLayout` (parallel/layout.py):
    the model gathers and splits weights as the layout says, the
    gradients are summed over the ranks that hold the same shard, and
    the update (`apply_adamw`, through the fused_update kernel where
    the registry says) runs on the local shards, in place. A pp call
    runs the pipelined step, which builds its own layouts. The loss is
    the global batch's mean, the same on every rank. Arguments past
    the batch (the resilient guard's poison) pass through to the
    `wrapper`, as its outputs past the triple do. `rebuild` retargets
    the same object at another mesh or plan (the elastic replan seam,
    reference :430)."""

    def __init__(self, cell, mesh, plan, cfg=None, overlap=False,
                 wrapper=None):
        self._cell = cell
        self._wrapper = wrapper
        self.mesh = mesh
        self.cfg = cfg
        self._adopt_plan(plan)
        self.overlap = bool(overlap)
        self.in_pins = None
        self.out_pins = None
        self._global = None
        self._derived = 0
        self.bubble_fraction = None

    @property
    def _pp(self) -> bool:
        return _plan_pp(self.plan) > 1

    @property
    def _fn(self):
        """The resolved step (the PipelinedStep under pp)."""
        return self._cell.fn

    def _adopt_plan(self, plan):
        """Set `plan`, or without one, on a mesh with an 'ep' or 'sp' axis
        (which the planner plans none of: the reference's tests build
        such meshes by hand), the mesh's own (`mesh_plan`)."""
        self._mesh_planned = plan is None and self.cfg is not None and \
            bool({"ep", "sp"} & set(axis_names(self.mesh)))
        self.plan = mesh_plan(self.cfg, self.mesh) if self._mesh_planned \
            else plan

    # ----------------------------------------------------------- pins
    def _specs(self):
        return (self.plan.specs if self.plan is not None
                and self.plan.specs else {})

    def _state_pins(self, tree):
        specs = self._specs()
        return _map_tree(lambda path, leaf: sharding_for(
            specs.get(leaf_path_name(path), P()), self.mesh,
            shape=_shape_of(path, leaf)), tree)

    def _batch_pins(self, tree):
        def pin(path, leaf):
            shape = tuple(leaf.shape)
            spec = (self.plan.batch_spec(len(shape))
                    if self.plan is not None and len(shape) else P())
            return sharding_for(spec, self.mesh, shape=shape)
        return _map_tree(pin, tree)

    def _replicated_pins(self, tree):
        rep = sharding_for(P(), self.mesh)
        return _map_tree(lambda path, leaf: rep, tree)

    def adopt_shapes(self, params, opt_state):
        """Pin the params and opt state from their FULL shapes (trees of
        tensors, arrays or shape tuples) without a call; the batch pins
        at the next call, which takes local trees."""
        self.in_pins = (self._state_pins(params),
                        self._state_pins(opt_state), None)
        self.out_pins = (self._replicated_pins(torch.zeros(())),
                         self.in_pins[0], self.in_pins[1])
        self._global = (_map_tree(_shape_of, params),
                        _map_tree(_shape_of, opt_state), None)
        if self._pp:
            self._fn.leaf_specs = {k: s.spec
                                        for k, s in self.in_pins[0].items()}

    def _derive(self, params, opt_state, batch):
        self.adopt_shapes(params, opt_state)
        self._pin_batch(batch)

    def _pin_batch(self, batch):
        """The batch pins, which complete a derivation."""
        self.in_pins = self.in_pins[:2] + (self._batch_pins(batch),)
        self._global = self._global[:2] + (
            _map_tree(lambda path, leaf: tuple(leaf.shape), batch),)
        self._derived += 1

    @property
    def trace_count(self) -> int:
        """How many times the pins were derived: 1 after the first call,
        and no later call derives again (the reference's
        zero-recompiles-after-warmup observable)."""
        return self._derived

    def shard_args(self, params, opt_state, batch):
        """(params, opt_state, batch) as full trees (numpy or tensors) ->
        this rank's shards, contiguous, on the rank's device. The first
        call derives the pins from these shapes."""
        if self.in_pins is None:
            self._derive(params, opt_state, batch)
        elif self.in_pins[2] is None:
            self._pin_batch(batch)
        trees = (params, opt_state, batch)
        for tree, shapes in zip(trees, self._global):
            got = _map_tree(lambda path, leaf: tuple(leaf.shape), tree)
            if got != shapes:
                raise ValueError(f"shard_args: shapes {got} are not the "
                                 f"pinned full shapes {shapes}")
        return tuple(_map_tree(lambda path, leaf, pins=pins: _pin_at(
            pins, path).shard(leaf), tree)
            for tree, pins in zip(trees, self.in_pins))

    def _local_batch(self, batch):
        if self.in_pins[2] is None:
            self._pin_batch(batch)
        shapes = _map_tree(lambda path, leaf: tuple(leaf.shape), batch)
        if shapes != self._global[2]:
            raise ValueError(f"sharded step: batch shapes {shapes}, want "
                             f"the full batch {self._global[2]}")
        return _map_tree(lambda path, leaf: _pin_at(
            self.in_pins[2], path).shard(leaf), batch)

    def _layout(self, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        tp = axis_size(self.mesh, "tp")
        # sequence parallelism where the config asks for it and the
        # sequence splits evenly over tp; otherwise the same function on
        # whole sequences
        sp = bool(getattr(self.cfg, "sequence_parallel", False) and tp > 1
                  and (int(tokens.shape[1]) - 1) % tp == 0)
        # the axes the rows are really split over (the batch pin's), over
        # which MoE routing exchanges its statistics
        pins = self.in_pins[2]
        pin = pins["tokens"] if isinstance(pins, dict) else pins
        split = _entry_axes(pin.spec[0]) if pin is not None and \
            len(pin.spec) else ()
        return ShardLayout(
            self.mesh, {k: s.spec for k, s in self.in_pins[0].items()},
            sequence_parallel=sp,
            batch_axes=(self.plan.batch_axes if self.plan is not None
                        else ("dp", "fsdp")), split_axes=split)

    def _run(self, fn, *args, batch):
        if self._pp:
            # the pipelined step builds its own layouts
            with use_mesh(self.mesh):
                return fn(*args)
        with use_mesh(self.mesh), use_layout(self._layout(batch)):
            return fn(*args)

    # ----------------------------------------------------------- calls
    def __call__(self, params, opt_state, batch, *rest):
        if self.in_pins is None:
            params, opt_state, batch = self.shard_args(params, opt_state,
                                                       batch)
        else:
            batch = self._local_batch(batch)
        try:
            out = self._run(self._wrapper or self._fn, params, opt_state,
                            batch, *rest, batch=batch)
        except torch.OutOfMemoryError as e:
            self._dump_oom_forensics(repr(e)[:500], params, opt_state, batch)
            raise
        if self._pp and self.bubble_fraction is None:
            from ..profiler import monitor
            self.bubble_fraction = float(self._fn.bubble)
            monitor.gauge("train.bubble_fraction").set(
                round(self.bubble_fraction, 6))
        return out

    def _dump_oom_forensics(self, error, params, opt_state, batch) -> None:
        """The `oom_forensics` flight dump of a step out of device memory
        (reference :386-420): the plan's `train_memory_ledger` at this
        batch, and the census of the step's argument tensors (leaf
        names, shapes, dtypes, pins) beside what else the allocator
        holds. Reads metadata only and keeps no reference to the failed
        call's tensors, so their memory returns once the error is
        dropped."""
        from ..profiler import flight_recorder, monitor
        from ..profiler.mem_audit import live_array_census
        ledger = None
        if self.cfg is not None and self.plan is not None:
            from ..cost_model import train_memory_ledger
            shapes = self._global[2] if self._global is not None else None
            tokens = shapes["tokens"] if isinstance(shapes, dict) else shapes
            if tokens is not None and len(tokens) >= 2:
                ledger = train_memory_ledger(
                    self.cfg, self.plan, global_batch=int(tokens[0]),
                    seq=max(int(tokens[1]) - 1, 1))
        pins = self.in_pins or (None, None, None)
        census = live_array_census(
            {"params": params, "opt_state": opt_state, "batch": batch},
            pins={"params": pins[0], "opt_state": pins[1],
                  "batch": pins[2]})
        monitor.counter("train.oom_forensics").add()
        rec = flight_recorder.recorder()
        rec.configure(oom_forensics={
            "where": "train_step", "error": error, "ledger": ledger,
            "census": census["rows"], "live_bytes": census["total_bytes"],
            "other_bytes": census["other_bytes"],
            "plan": getattr(self.plan, "name", repr(self.plan))})
        rec.note(oom_forensics="train_step")
        rec.dump("oom_forensics")

    def loss_and_grads(self, params, batch):
        """(global loss, this rank's reduced gradient shards) at the
        local `params`, for a full `batch`, without an update: what the
        step's update consumes."""
        batch = self._local_batch(batch)
        if self._pp:
            return self._run(self._fn.loss_and_grads, params, batch,
                             batch=batch)
        import sys
        family = sys.modules[type(self.cfg).__module__]
        return self._run(family.loss_and_grads, params, batch, self.cfg,
                         batch=batch)

    def gather_full(self, tree):
        """The unsharded tree (params, an opt state or gradients, keyed
        by leaf name) of local shards, on every rank: each leaf
        all-gathered over the axes its pin splits it over, a copy where
        it is not split (so a later in-place step leaves it as it was).
        Every rank must call it."""
        pins = self.in_pins[0]

        def full(path, leaf):
            pin = pins.get(leaf_path_name(path))
            out = leaf
            for d, entry in enumerate(() if pin is None else pin.spec):
                for axis in reversed(_entry_axes(entry)):
                    out = all_gather(out, axis_group(self.mesh, axis), d)
            return out.clone() if out is leaf else out
        return _map_tree(full, tree)

    def rebuild(self, mesh=None, plan=None):
        """The same object on another mesh or plan (reference :430):
        the cell's step resolved again for them (a wrapper keeps calling
        the cell), the pins derived again from the next call (or
        `adopt_shapes`), and the bubble read again."""
        if mesh is not None:
            self.mesh = mesh
        if plan is not None:
            self._adopt_plan(plan)
        elif mesh is not None and (self.plan is None or self._mesh_planned):
            self._adopt_plan(None)
        self.in_pins = self.out_pins = self._global = None
        self.bubble_fraction = None
        self._derived = 0
        self._cell.rebuild(self.mesh, self.plan)
        from ..profiler import monitor
        monitor.counter("facade_train_step_rebuilds").add()
        return self


def _pin_at(pins, path):
    for k in path:
        pins = pins[k]
    return pins


class FacadeModel(nn.Module):
    """The leaves of a functional core on a module, and `generate` over
    the family's serving engine. A subclass names its `_init_fn` and
    `_serving_family`."""
    _init_fn = None
    _serving_family = None

    def __init__(self, cfg, seed: int = 0, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = self._init_fn(cfg, seed, self.device)
        self._leaf_names = tuple(params)
        for name, v in params.items():
            v = torch.as_tensor(v).to(self.device)
            if v.is_floating_point():
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))
            else:
                self.register_buffer(name, v)
        self._engine = None
        self._engine_key = None

    def param_tree(self) -> Dict[str, torch.Tensor]:
        """{leaf name: tensor} in the functional core's layout."""
        return {n: getattr(self, n).detach() for n in self._leaf_names}

    def _weights_key(self):
        # identity and in-place version of every leaf: replacing or
        # updating a weight rebuilds the engine, so it never serves
        # stale weights
        return tuple((id(getattr(self, n)), getattr(self, n)._version)
                     for n in self._leaf_names)

    def generate(self, prompts, max_new_tokens, num_slots=8, max_len=None,
                 temperature=0.0, top_k=0, eos_id=None, max_top_k=0, seed=0,
                 deadline_s=None, deadline_ticks=None, max_ticks=None,
                 quant=None, **engine_kw):
        """Continuous-batching generation over this model's weights:
        `prompts` is a list of 1-D token-id sequences of mixed lengths;
        returns one array of generated ids per prompt, in order. The
        engine is cached and reused while its knobs and the weights stay
        the same. Other engine knobs pass through `engine_kw`: the cache
        layout (kv_layout, page_size, num_pages, prefill_chunk,
        prefix_sharing), speculative decode (spec_decode, gamma,
        draft_layers), tensor parallelism (mesh, tp_axis) and the
        guardrails and observability (max_queue, queue_policy,
        queue_ttl_s, watchdog_timeout, retries, backoff_base,
        backoff_max, guardrails, telemetry, telemetry_jsonl,
        telemetry_every, tracing) among them; a changed knob, a mesh of
        another topology or tp degree included, rebuilds the engine.
        `deadline_s` / `deadline_ticks` bound each request and
        `max_ticks` the drain; what they leave undelivered still
        resolves."""
        if quant is not None:
            engine_kw["quant"] = quant
        knobs = dict(engine_kw)
        if knobs.get("mesh") is not None:
            # a tensor-parallel engine is keyed by its mesh's topology and
            # tp degree, never shared with the single-device one
            from ..parallel.mesh import axis_names, axis_size
            mesh = knobs["mesh"]
            axis = knobs.get("tp_axis", "tp")
            knobs["mesh"] = (tuple(axis_names(mesh)), tuple(mesh.shape),
                             tuple(mesh.mesh.flatten().tolist()),
                             axis_size(mesh, axis))
        key = (num_slots, max_len, max_top_k, seed,
               tuple(sorted(knobs.items())), self._weights_key())
        if self._engine is None or self._engine_key != key:
            from ..inference.serving import create_serving_engine
            self._engine = create_serving_engine(
                self, num_slots=num_slots, max_len=max_len,
                max_top_k=max_top_k, seed=seed, **engine_kw)
            self._engine_key = key
        return self._engine.generate(prompts, max_new_tokens,
                                     temperature=temperature, top_k=top_k,
                                     eos_id=eos_id, deadline_s=deadline_s,
                                     deadline_ticks=deadline_ticks,
                                     max_ticks=max_ticks)


class GPTModel(FacadeModel):
    _init_fn = staticmethod(init_gpt_params)
    _serving_family = "gpt"

    def forward(self, tokens):
        """tokens [B, S] -> logits [B, S, V] (gpt_forward)."""
        return gpt_forward(self.param_tree(),
                           torch.as_tensor(tokens, device=self.device),
                           self.cfg)

    def loss(self, tokens):
        """Causal LM loss of tokens [B, S+1] (gpt_loss)."""
        return gpt_loss(self.param_tree(),
                        torch.as_tensor(tokens, device=self.device),
                        self.cfg)


class LlamaModel(FacadeModel):
    """`forward`, as the reference's LlamaModel, and `generate` over the
    Llama serving engine (grouped KV cache; weight-only int8 with
    quant="int8")."""
    _init_fn = staticmethod(init_llama_params)
    _serving_family = "llama"

    def forward(self, tokens):
        """tokens [B, S] -> logits [B, S, V] (llama_forward)."""
        return llama_forward(self.param_tree(),
                             torch.as_tensor(tokens, device=self.device),
                             self.cfg)
