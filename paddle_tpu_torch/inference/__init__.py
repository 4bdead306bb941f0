"""paddle_tpu_torch.inference — the continuous-batching serving engine."""
from .serving import (BackpressureError, PoolExhaustedError, Request,
                      ServingEngine, ServingFaultError, TERMINAL_REASONS,
                      create_serving_engine, family_for)

__all__ = ["ServingEngine", "Request", "create_serving_engine",
           "family_for", "TERMINAL_REASONS", "BackpressureError",
           "PoolExhaustedError", "ServingFaultError"]
