"""repro_torch.distributed — the fault-tolerance policies (restart policy,
straggler monitor, elastic re-mesh planning) and the single-process
gradient compression."""
from repro_torch.distributed.fault import (  # noqa: F401
    ElasticPlan,
    RestartPolicy,
    StragglerMonitor,
    plan_elastic_mesh,
    plan_recovery_mesh,
)
