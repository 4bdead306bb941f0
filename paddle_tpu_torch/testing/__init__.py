"""paddle_tpu_torch.testing — deterministic fault injection for the
training fault-tolerance runtime (counterpart of paddle_tpu/testing/).
Production modules expose hook seams (parallel.checkpoint.
_SHARD_WRITE_HOOK, parallel.resilience._STEP_HOOK); `faults.install()`
arms them from a declarative spec."""
from . import faults  # noqa: F401
