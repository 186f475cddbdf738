"""DeviceStream: the one place the serving engine moves data from the
device to the host.

Only the BLOCKING policy is ported: ``fetch`` copies a tensor to the host
at once and counts it in ``host_syncs``; nothing is ever in flight.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceStream:
    """Blocking sync policy: every transfer happens inline.  ``host_syncs``
    counts the device-to-host transfers."""

    def __init__(self) -> None:
        self.host_syncs = 0

    def fetch(self, arr, dtype=None) -> np.ndarray:
        """Device -> host transfer (THE sync point)."""
        self.host_syncs += 1
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        return np.asarray(arr) if dtype is None else np.asarray(arr, dtype)
