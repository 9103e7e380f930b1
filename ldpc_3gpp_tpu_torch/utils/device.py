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


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``'s card, or an H100's 132 for
    a CPU device: the launch shape a CPU run reports is the one an H100
    would get."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(dev).multi_processor_count
