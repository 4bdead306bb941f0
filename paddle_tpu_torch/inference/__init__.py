"""paddle_tpu_torch.inference — the continuous-batching serving engine
and the fleet over it: the router, admission, brownout, the request
journal and the autoscaler."""
from .serving import (BackpressureError, PoolExhaustedError, Request,
                      ServingEngine, ServingFaultError, TERMINAL_REASONS,
                      create_serving_engine, family_for)
from .router import EngineRouter, RouterRequest, create_router
from .autoscale import AutoscaleConfig, Autoscaler, EnginePreemptGuard
from .admission import (AdmissionController, QuotaExceededError,
                        TenantQuota)
from .brownout import BROWNOUT_LEVELS, BrownoutConfig, BrownoutController
from .journal import RequestJournal

__all__ = ["ServingEngine", "Request", "create_serving_engine",
           "family_for", "TERMINAL_REASONS", "BackpressureError",
           "PoolExhaustedError", "ServingFaultError",
           "EngineRouter", "RouterRequest", "create_router",
           "AutoscaleConfig", "Autoscaler", "EnginePreemptGuard",
           "AdmissionController", "TenantQuota", "QuotaExceededError",
           "BrownoutConfig", "BrownoutController", "BROWNOUT_LEVELS",
           "RequestJournal"]
