"""The port's device rule: ``cuda`` unless the caller names a device."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``cuda`` unless the caller names a device; raises when CUDA is asked
    for (explicitly or by default) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless device='cpu' "
            "is passed explicitly"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: the ``torch.distributed`` backend each device type takes
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def check_backend(device: torch.device, group=None) -> None:
    """Raise unless ``group`` (the default process group when None) is
    initialised with the backend ``device``'s tensors take: NCCL for
    ``cuda``, gloo for ``cpu``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call torch.distributed.init_process_group "
                           "first (torchrun sets one up for launch.train)")
    want, got = BACKENDS[device.type], dist.get_backend(group)
    if got != want:
        raise RuntimeError(f"{device.type} tensors take the {want} backend; the process "
                           f"group runs {got}")
