"""Device selection shared by every entry point of the port.

Entry points take ``device`` and default to ``"cuda"``.  Without a CUDA
device they raise instead of running on the CPU: a run on the CPU happens
only when the caller asks for it (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available on this machine; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
