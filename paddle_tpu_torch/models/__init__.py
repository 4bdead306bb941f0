"""Model families of the port (GPT: the train step and the cached
serving path so far)."""
from .facade import GPTModel, make_train_step
from .gpt import GPTConfig, init_gpt_params, init_opt_state, train_step

__all__ = ["GPTModel", "GPTConfig", "init_gpt_params", "init_opt_state",
           "make_train_step", "train_step"]
