"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device.

    `None` means "cuda"; asking for CUDA where there is none raises instead
    of quietly running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch twins"
        )
    return dev
