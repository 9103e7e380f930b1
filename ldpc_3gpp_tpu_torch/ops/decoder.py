"""Shared decoder result type, constants and the sum-product ``phi``.

LLR convention: positive LLR => bit 0 (MATLAB comm convention; fillers are
pinned to a large positive LLR by the caller, NRLDPCDecoder.m:264).

``_phi`` is evaluated by an explicit recipe of float32 operations instead of
``torch.tanh`` / ``torch.log``: the recipe reproduces, bit for bit, the
float32 ``tanh`` and ``log`` the JAX package's CPU path evaluates, so a
sum-product decode is held equal to it at tolerance 0 like the min-sum
family.  Library calls round differently (most visibly where ``tanh``
saturates to 1: phi is -0.0 by the recipe), and the CUDA kernels carry the
same recipe as a device function.

Still to port (ROADMAP.md): the segment-op flooding BP decoder that this
module holds in the JAX package (the correctness oracle of the flooding
paths).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_INF = 1e30
_PHI_MIN = 1e-9
_PHI_MAX = 38.0


class DecodeResult(NamedTuple):
    bits: torch.Tensor  # (..., num_cols*Z) int8 hard decisions
    parity_ok: torch.Tensor  # (...,) bool, True if H x = 0 at termination
    iterations: torch.Tensor  # (...,) int32 iterations used per codeword


def _c(value) -> float:
    """A constant as the float32 value the recipe uses, as a Python float."""
    return float(np.float32(value))


def _fma(a, b, c):
    """``a * b + c`` of float32 values rounded once: a fused multiply-add.

    The product of two float32 values is exact in float64.  The float64 sum
    is rounded to odd (where it is inexact, the neighbour with an odd last
    bit is taken: the error of the sum is known exactly by the two-sum
    identity), which makes the final rounding to float32 the rounding of the
    exact value: float64 carries more than two bits beyond float32.  Any
    operand may be a constant.
    """
    a, b, c = (v.double() if torch.is_tensor(v) else _c(v) for v in (a, b, c))
    p = a * b
    s = p + c
    part = s - p
    err = (p - (s - part)) + (c - part)  # exactly (p + c) - s
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


# Odd 13-degree numerator and even 6-degree denominator of the rational
# tanh approximation, highest power first.
_TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
           5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
           4.89352518554385e-03)
_TANH_TINY = 0.0004  # below: tanh(x) = x
_TANH_SAT = 7.99881172180175781  # from here on: tanh(x) = +-1


def _tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 tanh: rational approximation in x^2 evaluated with fused
    multiply-adds, identity for tiny |x|, +-1 from the saturation point."""
    ax = x.abs()
    x2 = x * x
    p = _fma(_TANH_P[0], x2, _TANH_P[1])
    for coeff in _TANH_P[2:]:
        p = _fma(p, x2, coeff)
    p = p * x
    q = _fma(_TANH_Q[0], x2, _TANH_Q[1])
    for coeff in _TANH_Q[2:]:
        q = _fma(q, x2, coeff)
    out = p / q
    one = torch.ones_like(x)
    out = torch.where(ax >= _c(_TANH_SAT), torch.where(x > 0, one, -one), out)
    return torch.where(ax < _c(_TANH_TINY), x, out)


_SQRT_HALF = 0.707106781186547524
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive normal values: exponent/mantissa
    split, a degree-8 mantissa polynomial in three interleaved parts, the
    ``e*q1`` term carried as the addend of the last polynomial step, and
    ``x - x^2/2`` summed before the polynomial."""
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) - 126).to(torch.float32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _c(_SQRT_HALF)
    zero = torch.zeros_like(m)
    tmp = torch.where(low, m, zero)
    e = e - torch.where(low, torch.ones_like(m), zero)
    m = m - 1.0
    m = m + tmp
    m2 = m * m
    m3 = m2 * m
    y = _fma(7.0376836292e-2, m, -1.1514610310e-1)
    y1 = _fma(-1.2420140846e-1, m, 1.4249322787e-1)
    y2 = _fma(2.0000714765e-1, m, -2.4999993993e-1)
    y = _fma(y, m, 1.1676998740e-1)
    y1 = _fma(y1, m, -1.6668057665e-1)
    y2 = _fma(y2, m, 3.3333331174e-1)
    y = _fma(y, m3, y1)
    y = _fma(y, m3, y2)
    y = _fma(y, m3, e * _c(_LOG_Q1))
    m = m - m2 * 0.5
    m = m + y
    return _fma(e, _LOG_Q2, m)


def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log(tanh(x/2)), self-inverse, clamped for stability."""
    x = torch.clamp(x.to(torch.float32), _c(_PHI_MIN), _c(_PHI_MAX))
    return -_log_f32(_tanh_f32(x * 0.5))
