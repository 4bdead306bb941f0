"""paddle_tpu_torch.inference — the continuous-batching serving engine."""
from .serving import (ServingEngine, Request, create_serving_engine,
                      family_for, TERMINAL_REASONS)

__all__ = ["ServingEngine", "Request", "create_serving_engine",
           "family_for", "TERMINAL_REASONS"]
