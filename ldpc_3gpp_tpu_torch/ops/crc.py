"""Batched GF(2) CRC attach/check as matrix products.

The reference delegates CRC to closed-source comm.CRCGenerator /
comm.CRCDetector System objects (NRLDPCEncoder.m:45-48, NRLDPCDecoder.m:113-115).
CRC over GF(2) is linear in the message, so for a fixed message length A the
checksum is ``p = (a @ T) mod 2`` with a precomputed (A, L) generator matrix
T[k] = x^(A-1-k+L) mod g(x).  That turns per-message bit-serial division into
one batched (batch, A) x (A, L) ``torch.matmul`` (the JAX package computes it
outside any kernel too, so the library product is the right tool here).

Exactness: operands are 0/1 and sums stay <= 8448+24 < 2^24, so the product
runs in float32 on every device and is exact (also where TF32 is allowed:
0/1 operands are TF32-representable and the accumulation is f32).  A
bfloat16 or float16 product is NOT usable here: ``torch.matmul`` returns the
inputs' dtype, and a sum of a few thousand does not fit its mantissa.

Bit convention matches TS38.212 Section 5.1: parity bits are appended
highest-degree coefficient first, zero initial shift-register state.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..spec.tables import CRC_LENGTHS, crc_poly_bits


@functools.lru_cache(maxsize=None)
def _remainder_table(crc: str, length: int, shifted: bool) -> np.ndarray:
    """(length, L) bit matrix of x^(length-1-k+L*shifted) mod g(x).

    ``shifted=True``  -> generator matrix (message is multiplied by x^L).
    ``shifted=False`` -> detector matrix (raw remainder of the received word).
    Row k holds the remainder's coefficients [x^(L-1), ..., x^0].
    """
    L = CRC_LENGTHS[crc]
    g = crc_poly_bits(crc)  # [x^L, ..., x^0], g[0] == 1
    assert g[0] == 1
    g_low = g[1:]  # remainder feedback taps, length L

    # Iterate r_k = x^(k) mod g upward from x^0.
    max_pow = (length - 1) + (L if shifted else 0)
    powers = np.zeros((max_pow + 1, L), dtype=np.int64)  # [x^(L-1)..x^0]
    if L == 0:
        return np.zeros((length, 0), dtype=np.int64)
    powers[0, L - 1] = 1  # x^0
    for p in range(1, max_pow + 1):
        prev = powers[p - 1]
        carry = prev[0]  # coefficient of x^(L-1) about to become x^L
        shifted_bits = np.concatenate([prev[1:], [0]])
        powers[p] = (shifted_bits + carry * g_low) % 2

    offset = L if shifted else 0
    # Row k corresponds to message bit k -> power (length-1-k) + offset.
    idx = (length - 1 - np.arange(length)) + offset
    return powers[idx]


@functools.lru_cache(maxsize=None)
def _table_device(crc: str, length: int, shifted: bool, device: torch.device):
    """The remainder table as a device tensor, cached per (crc, length, device)."""
    table = _remainder_table(crc, length, shifted).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _remainder(bits: torch.Tensor, crc: str, shifted: bool) -> torch.Tensor:
    """(..., n) 0/1 bits -> (..., L) float32 remainder bits (0.0 / 1.0)."""
    table = _table_device(crc, bits.shape[-1], shifted, bits.device)
    acc = torch.matmul(bits.to(torch.float32), table)
    return torch.remainder(acc, 2.0)


def crc_attach(a: torch.Tensor, crc: str) -> torch.Tensor:
    """Append the TS38.212 Section 5.1 CRC to each message in the batch.

    a: (..., A) 0/1 bits -> (..., A+L), same dtype and device.
    Replaces comm.CRCGenerator (NRLDPCEncoder.m:80-81).
    """
    if CRC_LENGTHS[crc] == 0:
        return a
    p = _remainder(a, crc, shifted=True).to(a.dtype)
    return torch.cat([a, p], dim=-1)


def crc_check(b: torch.Tensor, crc: str) -> torch.Tensor:
    """True where the CRC of each (..., B) word fails.

    Replaces comm.CRCDetector (NRLDPCDecoder.m:300, :336): returns the
    per-word error flag (remainder != 0).
    """
    if CRC_LENGTHS[crc] == 0:
        return torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)
    return (_remainder(b, crc, shifted=False) > 0.5).any(dim=-1)


def crc_numpy(a: np.ndarray, crc: str) -> np.ndarray:
    """Bit-serial oracle for tests: long division per TS38.212 Section 5.1."""
    L = CRC_LENGTHS[crc]
    if L == 0:
        return np.zeros(0, dtype=np.int64)
    g = crc_poly_bits(crc)
    buf = np.concatenate([np.asarray(a, dtype=np.int64), np.zeros(L, np.int64)])
    for i in range(len(a)):
        if buf[i]:
            buf[i : i + L + 1] ^= g
    return buf[-L:]
