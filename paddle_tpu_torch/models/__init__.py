"""Model families of the port: GPT and Llama, each with its train step
and its cached serving path."""
from .facade import GPTModel, LlamaModel, make_train_step
from .gpt import GPTConfig, init_gpt_params, init_opt_state, train_step
from .llama import LlamaConfig, init_llama_params

__all__ = ["GPTModel", "GPTConfig", "LlamaModel", "LlamaConfig",
           "init_gpt_params", "init_llama_params", "init_opt_state",
           "make_train_step", "train_step"]
