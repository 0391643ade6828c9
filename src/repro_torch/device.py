"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import List, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no GPU
    is present: there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev


def cuda_devices() -> List[torch.device]:
    """Every CUDA device, the default pool of the platform, the sweep
    engine and the island GA.  Raises when there is no GPU."""
    resolve_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
