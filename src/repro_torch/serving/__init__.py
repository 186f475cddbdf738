"""repro_torch.serving — the continuous-batching engine on the simulated
clock (chunked prefill, FCFS/SJF/priority admission, SLO metrics) over
the dense decoder runner, with blocking device-to-host transfers."""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.metrics import (  # noqa: F401
    RequestMetrics,
    ServingMetrics,
    percentile_summary,
)
from repro_torch.serving.runners import DecoderRunner  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    POLICIES,
    FCFSScheduler,
    PriorityScheduler,
    Scheduler,
    ShortestPromptFirst,
    get_scheduler,
)
from repro_torch.serving.stream import DeviceStream  # noqa: F401
