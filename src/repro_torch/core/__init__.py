# The paper's primary contribution — prefill scheduling with the layer axis
# as a first-class scheduling unit — and the token-axis baseline it is
# evaluated against.  The port registers only these two.
from repro_torch.core.base import SCHEDULERS, Scheduler, make_scheduler
from repro_torch.core.chunked import ChunkedPrefillScheduler
from repro_torch.core.layered import LayeredPrefillScheduler
from repro_torch.core.plan import (IterationPlan, PrefillSlice, Request,
                                   RequestState)

__all__ = [
    "Scheduler", "SCHEDULERS", "make_scheduler",
    "IterationPlan", "PrefillSlice", "Request", "RequestState",
    "ChunkedPrefillScheduler", "LayeredPrefillScheduler",
]
