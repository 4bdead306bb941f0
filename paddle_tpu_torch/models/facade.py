"""The model objects over the functional cores — `GPTModel` (`forward`,
`loss`) and `LlamaModel` (`forward`), each with `generate` over its
family's cached serving engine, on one leaf-holding base,
`FacadeModel` — and `make_train_step`, which makes the train-step
callable.

Counterpart of paddle_tpu/models/facade.py (`resolve_plan_step` :25,
`make_train_step` :95, `_ShardedTrainStep` :186-475,
`_PipelineTrainStep` :478-512, `FacadeModel` :515
with its `generate`), paddle_tpu/models/gpt.py
`GPTModel` (`forward` :650, `loss` :658) and paddle_tpu/models/llama.py
`LlamaModel` (:350-367). The leaves live on the module: floating leaves
as frozen nn.Parameters, integer leaves (a quantized tree's int8 pairs)
as buffers, under the reference's leaf names.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..parallel.collective import all_gather
from ..parallel.layout import ShardLayout, use_layout
from ..parallel.mesh import (P, _entry_axes, axis_group, axis_size,
                             leaf_path_name, sharding_for, use_mesh)
from .gpt import gpt_forward, gpt_loss, init_gpt_params
from .llama import init_llama_params, llama_forward

__all__ = ["FacadeModel", "GPTModel", "LlamaModel", "make_train_step",
           "resolve_plan_step"]


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


def make_train_step(step_fn, cfg=None, mesh=None, plan=None, overlap=None,
                    **step_kw):
    """The step callable `(params, opt_state, batch) -> (loss, params,
    opt_state)`: `step_fn` (the train_step of models/gpt.py or
    models/llama.py) with `cfg` and the optimizer keywords bound.
    PyTorch runs eagerly, so there is nothing to jit; the reference's
    buffer donation is the step's in-place update.

    With `mesh` (parallel.mesh.build_mesh, or `plan.build_mesh()`) and
    `plan` (parallel.planner.plan_train's TrainPlan), the step is the
    planner-driven step: each rank holds the shards the plan's specs
    give it and runs on them; `_ShardedTrainStep` for a dp×fsdp×tp
    plan, `_PipelineTrainStep` (the 1F1B pipelined step,
    parallel/pipeline_train.py) for a pp>1 plan, which needs the mesh.
    `overlap` (None: the plan's own field) is recorded and changes
    nothing: the reference's overlap is a set of XLA compiler options
    for the TPU (reference :234-249) and, under pp, a gather prefetch
    through its scan carry for XLA's scheduler; neither has a
    counterpart in an eager step."""
    if overlap is None:
        overlap = bool(getattr(plan, "overlap", False))
    if _plan_pp(plan) > 1:
        def remake(mesh, plan):
            return resolve_plan_step(step_fn, cfg=cfg, mesh=mesh, plan=plan,
                                     with_stats=True, overlap=overlap,
                                     **step_kw)
        return _PipelineTrainStep(remake(mesh, plan), mesh, plan, cfg=cfg,
                                  overlap=overlap, remake=remake)
    fn = resolve_plan_step(step_fn, cfg=cfg, plan=plan, **step_kw)
    if mesh is None:
        return fn
    return _ShardedTrainStep(fn, mesh, plan, cfg=cfg, overlap=overlap)


def _map_tree(fn, tree, path=()):
    """fn(path, leaf) over a nested dict of leaves, keeping its shape."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


class _ShardedTrainStep:
    """The planner-driven dp×fsdp×tp train step (reference :186-475).

    Pins come from the first call's shapes (`in_pins`: params, opt
    state, batch; `out_pins`: loss, params, opt state), as the
    reference's in/out shardings do:
    - every params and opt leaf pins by its leaf name through
      `plan.specs` (Adam's m and v mirror the param tree, so their
      moments shard like their params; unknown names, as opt["step"],
      replicate), shape-aware per parallel.mesh.sharding_for;
    - the batch's leading dim splits over the plan's `batch_axes`
      (dp×fsdp), degrading to replicated when it does not divide.

    Leaves are plain local tensors beside that pin table. `shard_args`
    turns full trees (numpy or tensors) into this rank's shards; the
    first call shards the trees it is given and returns the local ones,
    later calls take the local trees back and a full batch. A call runs
    the family step under a `ShardLayout` (parallel/layout.py): the
    model gathers and splits weights as the layout says, the gradients
    are summed over the ranks that hold the same shard, and the update
    (`apply_adamw`, through the fused_update kernel where the registry
    says) runs on the local shards, in place. The loss it returns is
    the global batch's mean, the same on every rank."""

    def __init__(self, fn, mesh, plan, cfg=None, overlap=False):
        self._fn = fn
        self.mesh = mesh
        self.plan = plan
        self.cfg = cfg
        self.overlap = bool(overlap)
        self.in_pins = None
        self.out_pins = None
        self._derived = 0

    # ----------------------------------------------------------- pins
    def _specs(self):
        return (self.plan.specs if self.plan is not None
                and self.plan.specs else {})

    def _state_pins(self, tree):
        specs = self._specs()
        return _map_tree(lambda path, leaf: sharding_for(
            specs.get(leaf_path_name(path), P()), self.mesh,
            shape=tuple(leaf.shape)), tree)

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

    def _derive(self, params, opt_state, batch):
        self.in_pins = (self._state_pins(params),
                        self._state_pins(opt_state),
                        self._batch_pins(batch))
        self.out_pins = (self._replicated_pins(torch.zeros(())),
                         self.in_pins[0], self.in_pins[1])
        self._global = tuple(_map_tree(lambda path, leaf: tuple(leaf.shape),
                                       t) for t in (params, opt_state, batch))
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
        return ShardLayout(
            self.mesh, {k: s.spec for k, s in self.in_pins[0].items()},
            sequence_parallel=sp,
            batch_axes=(self.plan.batch_axes if self.plan is not None
                        else ("dp", "fsdp")))

    def _run(self, fn, *args, batch):
        with use_mesh(self.mesh), use_layout(self._layout(batch)):
            return fn(*args)

    # ----------------------------------------------------------- calls
    def __call__(self, params, opt_state, batch):
        if self.in_pins is None:
            params, opt_state, batch = self.shard_args(params, opt_state,
                                                       batch)
        else:
            batch = self._local_batch(batch)
        return self._run(self._fn, params, opt_state, batch, batch=batch)

    def loss_and_grads(self, params, batch):
        """(global loss, this rank's reduced gradient shards) of the
        config family's loss at the local `params`, for a full `batch`,
        without an update: what the step's update consumes."""
        import sys
        family = sys.modules[type(self.cfg).__module__]
        batch = self._local_batch(batch)
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


class _PipelineTrainStep(_ShardedTrainStep):
    """make_train_step's pp>1 flavor (reference :478-512): the pins and
    the shard and gather methods are the base class's (a stacked leaf's
    pin cuts its layer axis over 'pp'), and the callable is the
    pipelined step (parallel/pipeline_train.py), whose output carries a
    trailing bubble fraction. The wrapper strips it, so callers see the
    facade triple, and keeps the first call's as `bubble_fraction` (the
    1F1B schedule's, which the plan's (pp, m) fix). The reference also publishes it as the
    `train.bubble_fraction` gauge, which waits for the port of its
    monitor (ROADMAP A7). `rebuild` retargets the step at another mesh
    or plan and resets the measurement."""

    def __init__(self, fn, mesh, plan, cfg=None, overlap=False,
                 remake=None):
        super().__init__(fn, mesh, plan, cfg=cfg, overlap=overlap)
        self._remake = remake
        self.bubble_fraction = None

    def _derive(self, params, opt_state, batch):
        super()._derive(params, opt_state, batch)
        self._fn.leaf_specs = {k: s.spec for k, s in self.in_pins[0].items()}

    def _run(self, fn, *args, batch):
        # the pipelined step builds its own layouts
        with use_mesh(self.mesh):
            return fn(*args)

    def __call__(self, params, opt_state, batch):
        out = super().__call__(params, opt_state, batch)
        if len(out) > 3 and self.bubble_fraction is None:
            self.bubble_fraction = float(out[3])
        return tuple(out[:3])

    def loss_and_grads(self, params, batch):
        """(global loss, this rank's reduced gradient shards) of the
        pipelined step at the local `params`, for a full `batch`,
        without an update."""
        batch = self._local_batch(batch)
        return self._run(self._fn.loss_and_grads, params, batch,
                         batch=batch)

    def rebuild(self, mesh=None, plan=None):
        """The same object on another mesh or plan: the pipelined step
        made again for them, the pins derived again from the next call,
        and the bubble read again."""
        self.mesh = mesh or self.mesh
        self.plan = plan or self.plan
        self._fn = self._remake(self.mesh, self.plan)
        self.in_pins = self.out_pins = None
        self.bubble_fraction = None
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
                 quant=None, **engine_kw):
        """Continuous-batching generation over this model's weights:
        `prompts` is a list of 1-D token-id sequences of mixed lengths;
        returns one array of generated ids per prompt, in order. The
        engine is cached and reused while its knobs and the weights stay
        the same. Other engine knobs pass through `engine_kw`: the cache
        layout (kv_layout, page_size, num_pages, prefill_chunk,
        prefix_sharing) and speculative decode (spec_decode, gamma,
        draft_layers) among them; a changed knob rebuilds the engine."""
        if quant is not None:
            engine_kw["quant"] = quant
        key = (num_slots, max_len, max_top_k, seed,
               tuple(sorted(engine_kw.items())), self._weights_key())
        if self._engine is None or self._engine_key != key:
            from ..inference.serving import create_serving_engine
            self._engine = create_serving_engine(
                self, num_slots=num_slots, max_len=max_len,
                max_top_k=max_top_k, seed=seed, **engine_kw)
            self._engine_key = key
        return self._engine.generate(prompts, max_new_tokens,
                                     temperature=temperature, top_k=top_k,
                                     eos_id=eos_id)


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
