"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on.

    CUDA is the default; asking for it without a usable card raises rather
    than carrying on quietly on the CPU.  Tests pass ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
