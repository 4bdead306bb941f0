"""Model families of the port: GPT (the train step and the cached
serving path) and Llama (the train step)."""
from .facade import GPTModel, LlamaModel, make_train_step
from .gpt import GPTConfig, init_gpt_params, init_opt_state, train_step
from .llama import LlamaConfig, init_llama_params

__all__ = ["GPTModel", "GPTConfig", "LlamaModel", "LlamaConfig",
           "init_gpt_params", "init_llama_params", "init_opt_state",
           "make_train_step", "train_step"]
