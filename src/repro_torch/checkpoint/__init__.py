"""repro_torch.checkpoint — atomic fault-tolerant checkpointing in the JAX
package's on-disk format."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    all_steps, latest_step, restore, restore_params, save, save_params,
    validate)
