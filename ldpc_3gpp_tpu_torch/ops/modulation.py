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

Ported so far: BPSK and QPSK, methods 'exact' and 'maxlog' (identical for
two-level PAM).  Still to port (ROADMAP.md): 16/64/256QAM modulation and
demodulation and the 'hard' method; those raise ``NotImplementedError``.
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


def _require_ported(modulation: str, method: str = "exact") -> None:
    if modulation not in Q_M:
        raise ValueError(f"unsupported modulation {modulation}")
    if modulation not in ("BPSK", "QPSK"):
        raise NotImplementedError(
            f"{modulation} is not ported yet (ROADMAP.md queue A: "
            "ops/modulation.py 16/64/256QAM)"
        )
    if method not in ("exact", "maxlog"):
        if method == "hard":
            raise NotImplementedError(
                "demodulation method 'hard' is not ported yet (ROADMAP.md "
                "queue A: ops/modulation.py)"
            )
        raise ValueError(f"unsupported method {method}")


def _psk_levels(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bits -> +-1/sqrt(2) float32 levels (the divisor rounded to f32)."""
    return (1.0 - 2.0 * bits.to(torch.float32)) / _SQRT2_F32


def modulate(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """Map (..., G) bits to (..., G/Q_m) complex64 symbols."""
    _require_ported(modulation)
    qm = Q_M[modulation]
    G = bits.shape[-1]
    assert G % qm == 0, "bit count must be a multiple of Q_m"
    s = _psk_levels(bits)
    if modulation == "BPSK":
        return torch.complex(s, s)
    pairs = s.reshape(s.shape[:-1] + (G // 2, 2))
    return torch.complex(pairs[..., 0], pairs[..., 1])


def modulate_planes(e_planes: torch.Tensor, modulation: str) -> torch.Tensor:
    """``modulate(interleave(e))`` with both element-shuffles fused away.

    The Section 5.4.2.2 interleaver (ops/rate_match.interleave) places
    deinterleaved stream i of ``e`` at bit position i of every symbol, so
    symbols are a function of the Q_m CONTIGUOUS planes of ``e`` and the
    per-element (S, Q_m) transpose never needs to materialize.

    e_planes: (..., Q_m, S) bits, plane i = e[i*S : (i+1)*S].
    Returns (..., S) symbols == ``modulate(interleave(e), modulation)``
    bit-exactly (identical arithmetic).
    """
    _require_ported(modulation)
    assert e_planes.shape[-2] == Q_M[modulation]
    v = _psk_levels(e_planes)
    if modulation == "BPSK":
        return torch.complex(v[..., 0, :], v[..., 0, :])
    return torch.complex(v[..., 0, :], v[..., 1, :])


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


def demodulate_planes(
    y: torch.Tensor, modulation: str, noise_var, method: str = "exact"
) -> torch.Tensor:
    """``deinterleave(demodulate(y))`` reshaped to LLR planes, shuffle-free.

    Returns (..., Q_m, S) float32 where plane i holds the LLRs of
    deinterleaved stream i (bit position i of every symbol) — exactly
    ``deinterleave(demodulate(y, ...), Q_m).reshape(..., Q_m, S)``, with the
    same per-element arithmetic.
    """
    _require_ported(modulation, method)
    scale = _psk_scale(noise_var)
    if modulation == "BPSK":
        return (scale * (y.real + y.imag)).unsqueeze(-2)
    return torch.stack([scale * y.real, scale * y.imag], dim=-2)


def demodulate(
    y: torch.Tensor, modulation: str, noise_var, method: str = "exact"
) -> torch.Tensor:
    """Soft demodulate (..., S) symbols to (..., S*Q_m) float32 LLRs.

    method: 'exact'  — true log-likelihood ratio
            'maxlog' — max-log approximation (equal to 'exact' for the
                       two-level axes of BPSK and QPSK)

    BPSK: LLR = 2 sqrt(2) (Re + Im)/var   (p0 = (1+j)/sqrt2)
    QPSK: b0 on Re, b1 on Im with levels +-1/sqrt2:
          LLR_bi = 2 sqrt(2) coord / var
    """
    _require_ported(modulation, method)
    qm = Q_M[modulation]
    scale = _psk_scale(noise_var)
    if modulation == "BPSK":
        llr = (scale * (y.real + y.imag)).unsqueeze(-1)
    else:
        llr = torch.stack([scale * y.real, scale * y.imag], dim=-1)
    return llr.reshape(y.shape[:-1] + (y.shape[-1] * qm,))
