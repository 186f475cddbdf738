"""repro_torch.optim — AdamW / SGD + schedules (the paper's finetuning
recipes)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    SGD, AdamW, AdamWState, SGDState, clip_by_global_norm,
    constant, cosine_one_cycle, exponential_decay, global_norm)
