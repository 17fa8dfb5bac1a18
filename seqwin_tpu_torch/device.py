"""Device selection for the port's entry points (no counterpart module).

``device=None`` means the GPU. Without one the entry points raise: the port
never carries on on the CPU unless the caller asks for it.
"""
from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The run asked for the GPU (the default) and there is none."""


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                'seqwin_tpu_torch runs on a CUDA device by default and none is '
                "available; pass device='cpu' to run the plain torch version")
        return torch.device('cuda')
    return torch.device(device)
