"""The model objects over the functional cores — `GPTModel` (`forward`,
`loss`) and `LlamaModel` (`forward`), each with `generate` over its
family's cached serving engine, on one leaf-holding base,
`FacadeModel` — and `make_train_step`, which makes the train-step
callable.

Counterpart of paddle_tpu/models/facade.py (`make_train_step` :95,
`FacadeModel` :515 with its `generate`), paddle_tpu/models/gpt.py
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
from .gpt import gpt_forward, gpt_loss, init_gpt_params
from .llama import init_llama_params, llama_forward

__all__ = ["FacadeModel", "GPTModel", "LlamaModel", "make_train_step"]


def make_train_step(step_fn, cfg=None, mesh=None, plan=None, **step_kw):
    """The step callable `(params, opt_state, batch) -> (loss, params,
    opt_state)`: `step_fn` (the train_step of models/gpt.py or
    models/llama.py) with `cfg` and the optimizer keywords bound.
    PyTorch runs eagerly, so there is nothing to jit; the reference's
    buffer donation is the step's in-place update. The planner-driven
    sharded step (`mesh=`, `plan=`) is not ported."""
    if mesh is not None or plan is not None:
        raise NotImplementedError(
            "make_train_step(mesh=, plan=): the sharded multi-GPU step is "
            "not ported yet (ROADMAP A6)")
    return functools.partial(step_fn, cfg=cfg, **step_kw)


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
