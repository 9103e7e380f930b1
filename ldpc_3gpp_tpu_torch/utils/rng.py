"""PRNG helpers for the Monte-Carlo chain.

Every random draw of the port takes an explicit ``torch.Generator``.  Runs
are deterministic for a fixed (seed, rank, device type, batch size) — the
reference's reproducibility contract (plot_BLER_vs_SNR.m:45 ``rng(seed)``).
The stream differs from the JAX package's by design (Philox vs rbg /
threefry): Monte-Carlo noise needs statistical quality only, so the two
packages are compared on the same numpy-made inputs, or on distributions.

Under ``torch.distributed`` every rank draws its own stream: the seed is
folded with the rank (``rank_seed``), the counterpart of the JAX package's
``jax.random.fold_in(key, axis_index)`` (``parallel/montecarlo.py:79``) and of
the reference's "one seed per MATLAB instance" (plot_BLER_vs_SNR.m:23-27).
"""
from __future__ import annotations

from typing import Optional

import torch

from .device import resolve_device

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One step of splitmix64 (Steele, Lea, Flood 2014): a bijection of
    64-bit words with full avalanche."""
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s stream in a run seeded ``seed``.

    Rank 0 keeps ``seed``, so a single-process run and every world-size-1
    run draw exactly the stream of ``make_generator(seed, device)`` without
    a process group.  Rank r > 0 takes

        splitmix64(splitmix64(seed mod 2**64) XOR r)

    a 64-bit word (``torch.Generator.manual_seed`` takes the full range).
    Not ``seed + r``: that would give rank 1 of seed s the stream of rank 0
    of seed s + 1.
    """
    if rank < 0:
        raise ValueError(f"rank must be >= 0, got {rank}")
    if rank == 0:
        return int(seed)
    return _splitmix64(_splitmix64(int(seed) & _MASK64) ^ int(rank))


def _default_rank() -> int:
    """The rank of the default process group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_generator(seed: int, device="cuda", rank: Optional[int] = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``rank_seed(seed,
    rank)``; ``rank=None`` takes the rank of the default process group (0
    without one, and in a world of one)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(rank_seed(seed, _default_rank() if rank is None else rank))
    return g
