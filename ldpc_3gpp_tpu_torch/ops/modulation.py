"""NR modulation and soft demodulation (TS38.211 Section 5.1).

The reference wraps comm.PSK/RectangularQAM Modulator/Demodulator objects with
hardcoded custom symbol mappings (NRModulator.m:72-84, NRDemodulator.m:75-84).
Those custom mappings are exactly the TS38.211 Section 5.1 constellations, so
here the constellations are generated directly from the 38.211 formulas:

- BPSK:    d = ((1-2b) + j(1-2b)) / sqrt(2)                     (pi/4 PSK)
- QPSK:    d = ((1-2b0) + j(1-2b1)) / sqrt(2)
- 16QAM:   d = ((1-2b0)(2-(1-2b2)) + j(1-2b1)(2-(1-2b3))) / sqrt(10)
- 64QAM / 256QAM: the corresponding nested Gray constructions.

LLR convention matches MATLAB comm demodulators: LLR = log P(b=0) - log P(b=1),
so a POSITIVE LLR means bit 0 (this is why fillers are pinned to a large
positive value, NRLDPCDecoder.m:264).  ``noise_var`` is the total complex
noise variance (the reference sets Variance = 10^(-EsN0/10),
plot_BLER_vs_SNR.m:106).

All five modulations and the three demodulation methods ('exact', 'maxlog',
'hard') are plain tensor code, as in the JAX package (no kernel there either).
Modulation and the 'maxlog' and 'hard' methods repeat the JAX package's
float32 operations one for one; 'exact' for the QAMs goes through
``torch.logsumexp``, whose exp/log round differently from XLA's (within 3e-7 of a
symbol's largest LLR in tests/test_torch_modulation_qam.py).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

MODULATIONS: Tuple[str, ...] = ("BPSK", "QPSK", "16QAM", "64QAM", "256QAM")

Q_M = {"BPSK": 1, "QPSK": 2, "16QAM": 4, "64QAM": 6, "256QAM": 8}

_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


@functools.lru_cache(maxsize=None)
def constellation(modulation: str) -> np.ndarray:
    """Complex constellation indexed by the symbol's bits MSB-first.

    Index m corresponds to bits (b0, ..., b_{Qm-1}) with b0 the MSB, matching
    the TS38.211 convention that b(Q_m*i) is the first bit of symbol i.
    """
    qm = Q_M[modulation]
    m = np.arange(1 << qm)
    b = ((m[:, None] >> (qm - 1 - np.arange(qm))) & 1).astype(np.float64)
    s = 1.0 - 2.0 * b  # bit -> sign: 0 -> +1, 1 -> -1

    if modulation == "BPSK":
        re = im = s[:, 0]
        norm = np.sqrt(2.0)
    elif modulation == "QPSK":
        re, im = s[:, 0], s[:, 1]
        norm = np.sqrt(2.0)
    elif modulation == "16QAM":
        re = s[:, 0] * (2.0 - s[:, 2])
        im = s[:, 1] * (2.0 - s[:, 3])
        norm = np.sqrt(10.0)
    elif modulation == "64QAM":
        re = s[:, 0] * (4.0 - s[:, 2] * (2.0 - s[:, 4]))
        im = s[:, 1] * (4.0 - s[:, 3] * (2.0 - s[:, 5]))
        norm = np.sqrt(42.0)
    elif modulation == "256QAM":
        re = s[:, 0] * (8.0 - s[:, 2] * (4.0 - s[:, 4] * (2.0 - s[:, 6])))
        im = s[:, 1] * (8.0 - s[:, 3] * (4.0 - s[:, 5] * (2.0 - s[:, 7])))
        norm = np.sqrt(170.0)
    else:
        raise ValueError(f"unsupported modulation {modulation}")

    return ((re + 1j * im) / norm).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _bit_masks(modulation: str) -> np.ndarray:
    """(2^Qm, Qm) 0/1 matrix: bit value of each constellation point."""
    qm = Q_M[modulation]
    m = np.arange(1 << qm)
    return ((m[:, None] >> (qm - 1 - np.arange(qm))) & 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pam_levels(modulation: str):
    """Per-axis PAM decomposition of a square NR QAM constellation.

    TS38.211 square QAMs are Gray-mapped independently per axis: even bits
    (b0, b2, ...) determine Re, odd bits (b1, b3, ...) determine Im, with
    identical level mappings.  Returns (levels (L,), bits (L, Qm/2)); the
    levels are exactly the float32 values of ``constellation()``.
    """
    qm = Q_M[modulation]
    assert qm % 2 == 0 and qm >= 2
    half = qm // 2
    pts = constellation(modulation)
    # levels for even-bit patterns with odd bits fixed to 0
    m = np.arange(1 << half)
    bits = ((m[:, None] >> (half - 1 - np.arange(half))) & 1).astype(np.float32)
    # interleave the even-bit pattern into the full symbol index (odd bits 0)
    idx = np.zeros(1 << half, dtype=np.int64)
    for k in range(half):
        idx |= ((m >> (half - 1 - k)) & 1) << (qm - 1 - 2 * k)
    levels = np.real(pts[idx]).astype(np.float32)
    return levels, bits


@functools.lru_cache(maxsize=None)
def _device_tables(modulation: str, device: torch.device):
    """Tensors on ``device``: the constellation, and for the square QAMs the
    per-axis levels (L,) and the -inf/0 masks (Qm/2, L) that leave the levels
    whose bit is 0 (``mask0``) or 1 (``mask1``)."""
    pts = torch.from_numpy(constellation(modulation)).to(device)
    if Q_M[modulation] < 2:
        return pts, None, None, None
    levels, bits = _pam_levels(modulation)
    one = torch.from_numpy(bits.T.copy()).to(device) > 0.5  # (half, L)
    neg_inf = torch.full(one.shape, -math.inf, dtype=torch.float32, device=device)
    zero = torch.zeros(one.shape, dtype=torch.float32, device=device)
    return (pts, torch.from_numpy(levels).to(device),
            torch.where(one, neg_inf, zero), torch.where(one, zero, neg_inf))


def _check(modulation: str, method: str = "exact") -> None:
    if modulation not in Q_M:
        raise ValueError(f"unsupported modulation {modulation}")
    if method not in ("exact", "maxlog", "hard"):
        raise ValueError(f"unsupported method {method}")


def _psk_levels(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bits -> +-1/sqrt(2) float32 levels (the divisor rounded to f32)."""
    return (1.0 - 2.0 * bits.to(torch.float32)) / _SQRT2_F32


def modulate(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """Map (..., G) bits to (..., G/Q_m) complex64 symbols."""
    _check(modulation)
    qm = Q_M[modulation]
    G = bits.shape[-1]
    assert G % qm == 0, "bit count must be a multiple of Q_m"
    if modulation in ("BPSK", "QPSK"):
        # closed form beats the table gather: just sign flips and a scale
        s = _psk_levels(bits)
        if modulation == "BPSK":
            return torch.complex(s, s)
        pairs = s.reshape(s.shape[:-1] + (G // 2, 2))
        return torch.complex(pairs[..., 0], pairs[..., 1])
    groups = bits.reshape(bits.shape[:-1] + (G // qm, qm)).to(torch.int64)
    weights = torch.tensor(
        [1 << (qm - 1 - k) for k in range(qm)], dtype=torch.int64, device=bits.device
    )
    idx = (groups * weights).sum(dim=-1)
    return _device_tables(modulation, bits.device)[0][idx]


def modulate_planes(e_planes: torch.Tensor, modulation: str) -> torch.Tensor:
    """``modulate(interleave(e))`` with both element-shuffles fused away.

    The Section 5.4.2.2 interleaver (ops/rate_match.interleave) places
    deinterleaved stream i of ``e`` at bit position i of every symbol, and
    TS38.211 square constellations map even/odd bit positions to the Re/Im
    axes independently, so symbols are a function of the Q_m CONTIGUOUS
    planes of ``e`` and the per-element (S, Q_m) transpose never needs to
    materialize.

    e_planes: (..., Q_m, S) bits, plane i = e[i*S : (i+1)*S].
    Returns (..., S) symbols == ``modulate(interleave(e), modulation)``
    bit-exactly (QPSK/BPSK by identical arithmetic; QAM reads the same
    per-axis level table the constellation defines).
    """
    _check(modulation)
    qm = Q_M[modulation]
    assert e_planes.shape[-2] == qm
    if modulation in ("BPSK", "QPSK"):
        v = _psk_levels(e_planes)
        if modulation == "BPSK":
            return torch.complex(v[..., 0, :], v[..., 0, :])
        return torch.complex(v[..., 0, :], v[..., 1, :])
    levels = _device_tables(modulation, e_planes.device)[1]
    half = qm // 2
    bits = e_planes.to(torch.int64)

    def axis_level(planes):  # (..., half, S) bits -> (..., S) level
        idx = planes[..., 0, :] << (half - 1)
        for k in range(1, half):
            idx = idx + (planes[..., k, :] << (half - 1 - k))
        return levels[idx]

    return torch.complex(
        axis_level(bits[..., 0::2, :]), axis_level(bits[..., 1::2, :])
    )


def _noise_var_tensor(noise_var, device) -> torch.Tensor:
    """``noise_var`` as a float32 tensor on ``device``: a division by a
    device tensor is a true float32 division on every backend (a Python
    scalar divisor may be turned into a multiplication by its reciprocal)."""
    return torch.as_tensor(noise_var, dtype=torch.float32, device=device)


def _psk_scale(noise_var):
    """LLR scale 2*sqrt(2)/noise_var of the two-level PAM axes.

    With a tensor ``noise_var`` the constant is rounded to float32 first and
    the division runs in float32, one rounding each, the order the JAX
    package takes; a Python number divides in double precision and is
    rounded to float32 where it meets the symbols.
    """
    if isinstance(noise_var, torch.Tensor):
        const = torch.tensor(
            2.0 * math.sqrt(2.0), dtype=torch.float32, device=noise_var.device
        )
        return const / noise_var.to(torch.float32)
    return float(np.float32(2.0 * math.sqrt(2.0) / float(noise_var)))


def _hard(llr: torch.Tensor) -> torch.Tensor:
    """Hard decisions as +-float32 max (finite, so sums of them stay clear of
    inf - inf)."""
    big = torch.finfo(llr.dtype).max
    return torch.where(llr >= 0, big, -big).to(llr.dtype)


def _pam_axis_planes(coord, modulation, noise_var, method):
    """One axis's PAM LLRs as bit planes: (..., S) real -> (..., half, S).

    Every valid bit has levels on both sides, so neither masked reduction is
    ever over -inf alone and no NaN can arise.
    """
    _, levels, mask0, mask1 = _device_tables(modulation, coord.device)
    nv = _noise_var_tensor(noise_var, coord.device)
    metric = -torch.square(coord.unsqueeze(-1) - levels) / nv  # (..., S, L)
    planes = []
    for b in range(mask0.shape[0]):
        if method == "exact":
            llr0 = torch.logsumexp(metric + mask0[b], dim=-1)
            llr1 = torch.logsumexp(metric + mask1[b], dim=-1)
        else:  # 'maxlog' and 'hard'
            llr0 = (metric + mask0[b]).amax(dim=-1)
            llr1 = (metric + mask1[b]).amax(dim=-1)
        planes.append(llr0 - llr1)
    return torch.stack(planes, dim=-2)  # (..., half, S)


def _demodulate_full(y, modulation, noise_var, method):
    """LLRs from the distances to every constellation point (BPSK 'hard')."""
    qm = Q_M[modulation]
    pts = _device_tables(modulation, y.device)[0]  # (M,)
    one = torch.from_numpy(_bit_masks(modulation).T.copy()).to(y.device) > 0.5
    nv = _noise_var_tensor(noise_var, y.device)
    metric = -(torch.square(torch.abs(y.unsqueeze(-1) - pts)) / nv)  # (..., S, M)
    neg_inf = torch.full_like(one, -math.inf, dtype=torch.float32)
    zero = torch.zeros_like(neg_inf)
    m0 = torch.where(one, neg_inf, zero)  # (qm, M): keeps the points with bit 0
    m1 = torch.where(one, zero, neg_inf)
    reduce = torch.logsumexp if method == "exact" else torch.amax
    llr0 = reduce(metric.unsqueeze(-2) + m0, dim=-1)
    llr1 = reduce(metric.unsqueeze(-2) + m1, dim=-1)
    llr = llr0 - llr1  # (..., S, qm); positive => bit 0
    if method == "hard":
        llr = _hard(llr)
    return llr.reshape(y.shape[:-1] + (y.shape[-1] * qm,))


def demodulate_planes(
    y: torch.Tensor, modulation: str, noise_var, method: str = "exact"
) -> torch.Tensor:
    """``deinterleave(demodulate(y))`` reshaped to LLR planes, shuffle-free.

    Returns (..., Q_m, S) float32 where plane i holds the LLRs of
    deinterleaved stream i (bit position i of every symbol) — exactly
    ``deinterleave(demodulate(y, ...), Q_m).reshape(..., Q_m, S)``, with the
    same per-element arithmetic, assembled from the demodulator's per-axis
    outputs by S-contiguous plane concatenation.
    """
    _check(modulation, method)
    qm = Q_M[modulation]
    if modulation in ("BPSK", "QPSK") and method != "hard":
        scale = _psk_scale(noise_var)
        if modulation == "BPSK":
            return (scale * (y.real + y.imag)).unsqueeze(-2)
        return torch.stack([scale * y.real, scale * y.imag], dim=-2)
    if qm >= 2:
        re_p = _pam_axis_planes(y.real, modulation, noise_var, method)
        im_p = _pam_axis_planes(y.imag, modulation, noise_var, method)
        # plane order re0, im0, re1, im1, ... = bit positions 0, 1, 2, 3, ...
        llr = torch.stack([re_p, im_p], dim=-2).reshape(
            y.shape[:-1] + (qm,) + y.shape[-1:]
        )
        return _hard(llr) if method == "hard" else llr
    # BPSK 'hard': one explicit transpose
    llr = demodulate(y, modulation, noise_var, method)
    return llr.reshape(llr.shape[:-1] + (y.shape[-1], qm)).transpose(-1, -2)


def demodulate(
    y: torch.Tensor, modulation: str, noise_var, method: str = "exact"
) -> torch.Tensor:
    """Soft demodulate (..., S) symbols to (..., S*Q_m) float32 LLRs.

    method: 'exact'  — true log-sum-exp LLR (MATLAB 'Log-likelihood ratio')
            'maxlog' — max-log approximation ('Approximate log-likelihood
                       ratio'; equal to 'exact' for BPSK and QPSK)
            'hard'   — hard decisions as +-float32 max ('Hard decision')

    BPSK: LLR = 2 sqrt(2) (Re + Im)/var   (p0 = (1+j)/sqrt2)
    QPSK: b0 on Re, b1 on Im with levels +-1/sqrt2:
          LLR_bi = 2 sqrt(2) coord / var
    Square QAMs decompose into independent per-axis PAM demodulation
    (TS38.211 Gray mapping): two 2^(Qm/2)-level metrics instead of one over
    2^Qm points, with the same LLRs.
    """
    _check(modulation, method)
    qm = Q_M[modulation]
    if modulation in ("BPSK", "QPSK") and method != "hard":
        scale = _psk_scale(noise_var)
        if modulation == "BPSK":
            llr = (scale * (y.real + y.imag)).unsqueeze(-1)
        else:
            llr = torch.stack([scale * y.real, scale * y.imag], dim=-1)
        return llr.reshape(y.shape[:-1] + (y.shape[-1] * qm,))
    if qm < 2:
        return _demodulate_full(y, modulation, noise_var, method)
    # interleave: even bit positions from Re, odd from Im
    llr = demodulate_planes(y, modulation, noise_var, method)  # (..., qm, S)
    return llr.transpose(-1, -2).reshape(y.shape[:-1] + (y.shape[-1] * qm,))
