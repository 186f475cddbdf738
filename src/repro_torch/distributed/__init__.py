"""repro_torch.distributed — of the JAX package's fault-tolerance and
straggler policies, the trailing-median ``StragglerMonitor`` the serving
engine reads."""
from repro_torch.distributed.fault import StragglerMonitor  # noqa: F401
