"""Device selection shared by the port's entry points.

The port runs on the card: an entry point given no device takes ``cuda``,
and raises on a machine without one.  Only an explicit ``device="cpu"``
gives the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
