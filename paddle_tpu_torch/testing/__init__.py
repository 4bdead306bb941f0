"""paddle_tpu_torch.testing — deterministic fault injection for the
fault-tolerance runtime (counterpart of paddle_tpu/testing/). Production
modules expose hook seams (parallel.checkpoint._SHARD_WRITE_HOOK,
parallel.resilience._STEP_HOOK, parallel.elastic._FAULT_HOOK,
inference.serving._FAULT_HOOK); `faults.install()` arms them from a
declarative spec."""
from . import faults  # noqa: F401
