"""The device rule shared by every public entry point of the port.

``device=None`` means the CUDA card.  A CUDA device that is not present
raises: nothing falls back to the CPU.  The CPU is used only when the caller
asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise ``RuntimeError`` for a CUDA device that is
    not present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch engine on the CPU")
    return dev
