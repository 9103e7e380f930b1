"""Device resolution shared by the port's entry points.

Entry points default to ``device="cuda"`` and raise when no CUDA device is
present; the CPU is used only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (or CPU tensors) "
            "to run the plain PyTorch path on the host"
        )
    return dev
