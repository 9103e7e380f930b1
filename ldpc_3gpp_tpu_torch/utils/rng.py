"""PRNG helper for the Monte-Carlo chain.

Every random draw of the port takes an explicit ``torch.Generator``.  Runs
are deterministic for a fixed (seed, device type, batch size) — the
reference's reproducibility contract (plot_BLER_vs_SNR.m:45 ``rng(seed)``).
The stream differs from the JAX package's by design (Philox vs rbg /
threefry): Monte-Carlo noise needs statistical quality only, so the two
packages are compared on the same numpy-made inputs, or on distributions.
"""
from __future__ import annotations

import torch

from .device import resolve_device


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
