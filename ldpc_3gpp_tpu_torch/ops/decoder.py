"""Shared decoder result type and constants.

LLR convention: positive LLR => bit 0 (MATLAB comm convention; fillers are
pinned to a large positive LLR by the caller, NRLDPCDecoder.m:264).

Still to port (ROADMAP.md): the segment-op flooding BP decoder that this
module holds in the JAX package (the correctness oracle of the flooding
paths).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_INF = 1e30
_PHI_MIN = 1e-9
_PHI_MAX = 38.0


class DecodeResult(NamedTuple):
    bits: torch.Tensor  # (..., num_cols*Z) int8 hard decisions
    parity_ok: torch.Tensor  # (...,) bool, True if H x = 0 at termination
    iterations: torch.Tensor  # (...,) int32 iterations used per codeword
