"""repro_torch.distributed — the fault-tolerance policies (restart policy,
straggler monitor) and the single-process gradient compression."""
from repro_torch.distributed.fault import (  # noqa: F401
    RestartPolicy,
    StragglerMonitor,
)
