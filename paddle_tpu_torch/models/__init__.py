"""Model families of the port (GPT's cached serving path so far)."""
from .facade import GPTModel
from .gpt import GPTConfig, init_gpt_params

__all__ = ["GPTModel", "GPTConfig", "init_gpt_params"]
