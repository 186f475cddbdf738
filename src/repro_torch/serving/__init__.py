"""repro_torch.serving — the continuous-batching engine (chunked prefill,
FCFS/SJF/priority admission, SLO metrics) over the decoder and recurrent
runners: every pass shape warmed into a CUDA graph on a GPU, blocking
transfers on the simulated clock or the overlapped runtime on a wall
clock, per-slot KV
strips or a paged KV pool with prefix sharing, preemption, backpressure,
degraded mode, tenant quotas and deadlines; seeded fault injection,
fingerprint detection and recovery on every model family
(``serving.faults``); multi-model fleets of single-model lanes on one
clock (``serving.fleet``)."""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.faults import (  # noqa: F401
    FAULT_KINDS,
    Detection,
    FaultConfig,
    FaultEvent,
    FaultPlan,
    drift_detect_rtol,
    make_fault_plan,
)
from repro_torch.serving.fleet import FleetEngine  # noqa: F401
from repro_torch.serving.metrics import (  # noqa: F401
    RequestMetrics,
    ServingMetrics,
    percentile_summary,
)
from repro_torch.serving.pages import (  # noqa: F401
    PagePool,
    pages_needed,
    plan_chunk,
    prefix_key,
)
from repro_torch.serving.runners import (  # noqa: F401
    DecoderRunner,
    EncDecRunner,
    RecurrentRunner,
    runner_for,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    POLICIES,
    FCFSScheduler,
    PriorityScheduler,
    Scheduler,
    ShortestPromptFirst,
    get_scheduler,
)
from repro_torch.serving.stream import (  # noqa: F401
    DeviceStream,
    OverlappedStream,
    Ticket,
    TokenRec,
)
