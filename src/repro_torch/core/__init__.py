# The paper's primary contribution: prefill scheduling with the layer axis
# as a first-class scheduling unit (plus the token-axis baselines it is
# evaluated against, and the §4.3 hybrid generalization).
from repro_torch.core.base import SCHEDULERS, Scheduler, make_scheduler
from repro_torch.core.chunked import ChunkedPrefillScheduler
from repro_torch.core.continuous import ContinuousBatchingScheduler
from repro_torch.core.hybrid import HybridPrefillScheduler
from repro_torch.core.layered import LayeredPrefillScheduler
from repro_torch.core.plan import (IterationPlan, PrefillSlice, Request,
                                   RequestState)
from repro_torch.core.static_batch import StaticBatchScheduler

__all__ = [
    "Scheduler", "SCHEDULERS", "make_scheduler",
    "IterationPlan", "PrefillSlice", "Request", "RequestState",
    "ChunkedPrefillScheduler", "LayeredPrefillScheduler",
    "ContinuousBatchingScheduler", "StaticBatchScheduler",
    "HybridPrefillScheduler",
]
