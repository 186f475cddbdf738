"""repro_torch.distributed — the fault-tolerance policies (restart policy,
straggler monitor, elastic re-mesh planning), the single-process
gradient compression, and the sharding rules and placements over a (data,
model) mesh (``distributed.sharding``)."""
from repro_torch.distributed.fault import (  # noqa: F401
    ElasticPlan,
    RestartPolicy,
    StragglerMonitor,
    plan_elastic_mesh,
    plan_recovery_mesh,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    Mesh,
    NamedSharding,
    P,
    named_sharding_tree,
    serving_param_spec_tree,
    shard_decode_state,
    shard_params,
    shard_serving_params,
    zero1_state_sharding,
)
