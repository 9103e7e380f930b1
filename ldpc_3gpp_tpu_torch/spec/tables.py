"""TS38.212 standards tables: base graphs, lifting sizes, CRC polynomials.

Data provenance (all of it is 3GPP spec data, not reference code):
- Base graphs: TS38.212 Tables 5.3.2-2 (BG1: 316 edges, 46x68) and 5.3.2-3
  (BG2: 197 edges, 42x52), stored as (row, col, shift[i_LS]) edge lists in
  ``base_graphs.npz`` (a byte copy of the JAX package's file, extracted by
  tools/extract_tables.py; reference: get_3gpp_base_graph.m:12-530).
- Lifting sizes: TS38.212 Table 5.3.2-1 — 8 sets, 51 Z values
  (reference: get_3gpp_valid_lifting_sizes.m:3-12).
- CRC polynomials: TS38.212 Section 5.1
  (reference: get_3gpp_crc_polynomial.m:3-14).

Unlike the reference we never materialise the lifted parity-check matrix
(get_pcm.m builds a (46Z x 68Z) sparse matrix); the (row, col, shift) edge
list IS the PCM representation used by every kernel — circulant blocks are
applied as Z-length rolls.

This module is the port's own copy of ``ldpc_3gpp_tpu/spec/tables.py``
(pure numpy); the port imports nothing of the JAX package.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "base_graphs.npz")

# --- Lifting sizes: TS38.212 Table 5.3.2-1 -------------------------------
# Set i_LS -> valid Z values (a * 2^j with a in {2,3,5,7,9,11,13,15}).
LIFTING_SETS: Tuple[Tuple[int, ...], ...] = (
    (2, 4, 8, 16, 32, 64, 128, 256),
    (3, 6, 12, 24, 48, 96, 192, 384),
    (5, 10, 20, 40, 80, 160, 320),
    (7, 14, 28, 56, 112, 224),
    (9, 18, 36, 72, 144, 288),
    (11, 22, 44, 88, 176, 352),
    (13, 26, 52, 104, 208),
    (15, 30, 60, 120, 240),
)

ALL_LIFTING_SIZES: Tuple[int, ...] = tuple(
    sorted(z for s in LIFTING_SETS for z in s)
)

# --- CRC polynomials: TS38.212 Section 5.1 --------------------------------
# Coefficient lists are highest-degree first, including the leading and
# trailing terms, e.g. CRC16 = z^16 + z^12 + z^5 + 1.
CRC_POLYNOMIALS: Dict[str, Tuple[int, ...]] = {
    # z^24 + z^23 + z^18 + z^17 + z^14 + z^11 + z^10 + z^7 + z^6 + z^5 + z^4 + z^3 + z + 1
    "CRC24A": (24, 23, 18, 17, 14, 11, 10, 7, 6, 5, 4, 3, 1, 0),
    # z^24 + z^23 + z^6 + z^5 + z + 1
    "CRC24B": (24, 23, 6, 5, 1, 0),
    # z^16 + z^12 + z^5 + 1
    "CRC16": (16, 12, 5, 0),
    "None": (),
}

CRC_LENGTHS: Dict[str, int] = {"CRC24A": 24, "CRC24B": 24, "CRC16": 16, "None": 0}

# Base graph dimensions: (num_check_rows, num_cols, num_systematic_cols)
BG_DIMS: Dict[int, Tuple[int, int, int]] = {
    1: (46, 68, 22),
    2: (42, 52, 10),
}


def crc_poly_bits(name: str) -> np.ndarray:
    """CRC polynomial as a 0/1 coefficient vector [z^L, ..., z^1, z^0]."""
    L = CRC_LENGTHS[name]
    bits = np.zeros(L + 1, dtype=np.int64)
    for p in CRC_POLYNOMIALS[name]:
        bits[L - p] = 1
    return bits


@functools.lru_cache(maxsize=None)
def _load() -> Dict[str, np.ndarray]:
    with np.load(_DATA) as f:
        return {k: f[k] for k in f.files}


@functools.lru_cache(maxsize=None)
def base_graph(bg: int, i_ls: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edge list of base graph ``bg`` for lifting set ``i_ls``.

    Returns (rows, cols, shifts) int32 arrays of length 316 (BG1) or 197
    (BG2).  Shifts are the raw TS38.212 values V(i,j); they must be reduced
    mod Z before use (TS38.212 Section 5.3.2: P = V mod Z).

    Reference: get_3gpp_base_graph.m:12-530 (same data, as +1-offset sparse).
    """
    if bg not in (1, 2):
        raise ValueError("BG must be 1 or 2")
    if not 0 <= i_ls <= 7:
        raise ValueError("i_LS must be in 0..7")
    d = _load()
    return (
        d[f"bg{bg}_row"].astype(np.int32),
        d[f"bg{bg}_col"].astype(np.int32),
        d[f"bg{bg}_shift"][:, i_ls].astype(np.int32),
    )


def lifting_size(K_b: int, K_prime: int) -> int:
    """Smallest valid Z with K_b * Z >= K_prime (TS38.212 Section 5.2.2).

    Reference: get_3gpp_lifting_size.m:7-16.
    """
    candidates = [z for z in ALL_LIFTING_SIZES if K_b * z >= K_prime]
    if not candidates:
        raise UnsupportedParameters("Invalid block length.")
    return min(candidates)


def set_index(Z: int) -> int:
    """Lifting set index i_LS containing Z (TS38.212 Section 5.3.2).

    Reference: get_3gpp_set_index.m:5-11.
    """
    for i, s in enumerate(LIFTING_SETS):
        if Z in s:
            return i
    raise UnsupportedParameters("Invalid lifting size.")


def lifted_pcm_dense(bg: int, i_ls: int, Z: int) -> np.ndarray:
    """Materialise the full lifted PCM as a dense 0/1 uint8 matrix.

    Equivalent to the reference's get_pcm.m (circshift(speye(Z), shift) per
    base edge) — provided for inspection/interop only; no kernel ever builds
    this (they use the edge list + rolls).
    """
    rows, cols, shifts = base_graph(bg, i_ls)
    nr, nc, _ = BG_DIMS[bg]
    H = np.zeros((nr * Z, nc * Z), dtype=np.uint8)
    z = np.arange(Z)
    for r, c, s in zip(rows, cols, shifts):
        H[r * Z + z, c * Z + (z + s % Z) % Z] ^= 1
    return H


class UnsupportedParameters(ValueError):
    """Raised for parameter combinations outside TS38.212.

    Mirrors the reference's 'ldpc_3gpp_matlab:UnsupportedParameters' error id
    (NRLDPC.m:240-294): sweep scripts catch this and skip the config.
    """
