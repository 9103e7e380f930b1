"""Quasi-cyclic LDPC encoder over lifted circulant blocks.

The reference hands encoding to comm.LDPCEncoder with a fully materialised
(46Z x 68Z) sparse PCM (NRLDPCEncoder.m:49,158 / get_pcm.m).  Here the NR
base-graph structure is exploited directly — no PCM is ever built:

1. The 4 "core" check rows and first 4 parity columns form a double-diagonal
   with a single accumulated rotation.  XORing the 4 core-row syndromes
   cancels the double diagonal, leaving one net rotation of p0; the other
   three core parities follow by back-substitution (each remaining core row
   has exactly one unknown).
2. Extension rows (4..m-1) have an identity diagonal on their own parity
   column, so extension parity = XOR of rotated earlier blocks.

Every circulant multiply P^s * v is a Z-length roll: (P^s v)[z] = v[(z+s) % Z],
i.e. torch.roll(v, -s, dims=-1).  All ops are batched elementwise XORs on
(batch, Z) uint8 blocks.

The encode plan (which columns/shifts feed which row, and the core solve
order) is resolved once per LDPCParams in numpy and cached.

``encode_mxu`` is the other encoder: the parity as one dense GF(2) matrix
product with the generator the roll plan builds (``_parity_generator``).
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..spec.params import LDPCParams


@functools.lru_cache(maxsize=None)
def _encode_plan(params: LDPCParams):
    """Static encode plan: per-row edge lists and the core parity solve order.

    Returns (core_rows, sum_shift, core_solve, ext_rows) where
    - core_rows[i]   = [(col, shift)] systematic edges of core row i (i<4)
    - sum_shift      = net rotation x with P^x p0 = XOR of core syndromes
    - core_solve     = [(row, target_col, target_shift, [(known_pcol, shift)])]
      back-substitution steps in dependency order
    - ext_rows[m]    = [(col, shift)] edges of extension row m (col < kb+4)
    """
    rows, cols, shifts = params.edges
    kb = params.num_sys_cols
    Z = params.Z_c

    core_rows: List[List[Tuple[int, int]]] = [[] for _ in range(4)]
    core_parity: List[List[Tuple[int, int]]] = [[] for _ in range(4)]
    ext_rows: List[List[Tuple[int, int]]] = [[] for _ in range(params.num_rows - 4)]

    for r, c, s in zip(rows, cols, shifts):
        r, c, s = int(r), int(c), int(s)
        if r < 4:
            if c < kb:
                core_rows[r].append((c, s))
            else:
                core_parity[r].append((c, s))
        else:
            if c < kb + 4:
                ext_rows[r - 4].append((c, s))
            else:
                # Identity diagonal on this row's own parity column.
                assert c == kb + r and s % Z == 0, (r, c, s)

    # Net rotation of p0 when XORing all four core rows: the double-diagonal
    # columns (kb+1..kb+3) each appear exactly twice with equal shifts and
    # cancel; column kb survives with exactly one net shift.
    counts = Counter()
    for i in range(4):
        for c, s in core_parity[i]:
            counts[(c, s % Z)] += 1
    surviving = [(c, s) for (c, s), n in counts.items() if n % 2 == 1]
    assert len(surviving) == 1 and surviving[0][0] == kb, surviving
    sum_shift = surviving[0][1]

    # Back-substitution order: repeatedly pick a core row with exactly one
    # unresolved parity column.
    resolved = {kb}
    core_solve = []
    remaining_rows = set(range(4))
    while len(resolved) < 4:
        progress = False
        for i in sorted(remaining_rows):
            unknown = [(c, s) for c, s in core_parity[i] if c not in resolved]
            if len(unknown) == 1:
                (tc, ts) = unknown[0]
                known = [(c, s) for c, s in core_parity[i] if c in resolved]
                core_solve.append((i, tc, ts % Z, known))
                resolved.add(tc)
                remaining_rows.discard(i)
                progress = True
                break
        assert progress, "core parity structure is not triangular"

    return core_rows, sum_shift, core_solve, ext_rows


def _rot(v: torch.Tensor, s: int) -> torch.Tensor:
    """Apply circulant P^s: (P^s v)[z] = v[(z+s) % Z]."""
    return v if s == 0 else torch.roll(v, -s, dims=-1)


def _xor_rotated(blocks: torch.Tensor, terms) -> torch.Tensor:
    """XOR of P^s * blocks[..., col, :] over (col, shift) terms."""
    acc = None
    for c, s in terms:
        t = _rot(blocks[..., c, :], s)
        acc = t if acc is None else acc ^ t
    if acc is None:
        return torch.zeros(
            blocks.shape[:-2] + blocks.shape[-1:],
            dtype=blocks.dtype, device=blocks.device,
        )
    return acc


def encode(params: LDPCParams, c: torch.Tensor) -> torch.Tensor:
    """LDPC-encode systematic bits into the full lifted codeword.

    c: (..., K) 0/1 bits per code block, filler positions already set to 0
    (TS38.212 Section 5.3.2; the reference encodes fillers as 0 too,
    NRLDPCEncoder.m:150-155).

    Returns uint8 cw: (..., num_cols * Z) with cw[..., :K] == c and H @ cw = 0,
    on the device of ``c``.  The rate-matching buffer d is cw[..., 2Z:] (the
    first 2Z systematic bits are punctured, NRLDPCEncoder.m:149-156).
    """
    Z = params.Z_c
    kb = params.num_sys_cols
    assert c.shape[-1] == params.K == kb * Z
    core_rows, sum_shift, core_solve, ext_rows = _encode_plan(params)

    u8 = c.to(torch.uint8)
    sys_blocks = u8.reshape(u8.shape[:-1] + (kb, Z))

    # Core-row syndromes from systematic bits.
    lam = [_xor_rotated(sys_blocks, core_rows[i]) for i in range(4)]

    # Solve p0: P^sum_shift p0 = lam0 ^ lam1 ^ lam2 ^ lam3.
    S = lam[0] ^ lam[1] ^ lam[2] ^ lam[3]
    parity = {kb: torch.roll(S, sum_shift, dims=-1) if sum_shift else S}

    # Back-substitute the remaining core parities.
    for row, tc, ts, known in core_solve:
        rhs = lam[row]
        for c_k, s_k in known:
            rhs = rhs ^ _rot(parity[c_k], s_k)
        parity[tc] = torch.roll(rhs, ts, dims=-1) if ts else rhs

    core_p = torch.stack([parity[kb + i] for i in range(4)], dim=-2)
    blocks = torch.cat([sys_blocks, core_p], dim=-2)  # (..., kb+4, Z)

    # Extension parities: p_m = XOR of rotated earlier blocks in row m.
    ext_p = [_xor_rotated(blocks, terms) for terms in ext_rows]
    all_blocks = torch.cat(
        [blocks, torch.stack(ext_p, dim=-2)], dim=-2
    )  # (..., num_cols, Z)

    return all_blocks.reshape(u8.shape[:-1] + (params.num_cols * Z,))


@functools.lru_cache(maxsize=2)
def _parity_generator(params: LDPCParams) -> np.ndarray:
    """Dense GF(2) parity generator: parity = (c @ Gp) mod 2, Gp (K, P).

    Built once per config by running the structured roll-plan on the K basis
    vectors in numpy.  Stored as float32 numpy (597 MB at BG1 Z=384);
    ``parity_generator_device`` keeps the device copy.
    """
    Z, kb = params.Z_c, params.num_sys_cols
    K = params.K
    P = (params.num_cols - kb) * Z
    core_rows, sum_shift, core_solve, ext_rows = _encode_plan(params)

    # identity batch: basis[j] has bit j set
    sys_blocks = np.eye(K, dtype=np.uint8).reshape(K, kb, Z)

    def rot(v, s):
        return v if s % Z == 0 else np.roll(v, -(s % Z), axis=-1)

    def xor_rotated(blocks, terms):
        acc = np.zeros((K, Z), np.uint8)
        for c, s in terms:
            acc ^= rot(blocks[:, c, :], s)
        return acc

    lam = [xor_rotated(sys_blocks, core_rows[i]) for i in range(4)]
    S = lam[0] ^ lam[1] ^ lam[2] ^ lam[3]
    parity = {kb: np.roll(S, sum_shift, axis=-1) if sum_shift else S}
    for row, tc, ts, known in core_solve:
        rhs = lam[row].copy()
        for c_k, s_k in known:
            rhs ^= rot(parity[c_k], s_k)
        parity[tc] = np.roll(rhs, ts, axis=-1) if ts else rhs

    blocks = np.concatenate(
        [sys_blocks] + [parity[kb + i][:, None, :] for i in range(4)], axis=1
    )
    ext = [xor_rotated(blocks, terms) for terms in ext_rows]
    all_parity = np.concatenate(
        [parity[kb + i] for i in range(4)] + ext, axis=-1
    )
    assert all_parity.shape == (K, P)
    return all_parity.astype(np.float32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# torch._int_mm on CUDA takes more than 16 rows and inner and column sizes
# that are multiples of 8; the generator and the rows are zero-padded to fit
# (the padding adds only zero terms, so the product is unchanged).
_MIN_ROWS = 17
_SIZE_MULTIPLE = 8


@functools.lru_cache(maxsize=2)
def parity_generator_device(params: LDPCParams, device) -> torch.Tensor:
    """``_parity_generator`` on ``device`` as int8 0/1, zero-padded to
    (K8, P8), the multiples of 8 at or above K and P.

    One byte per entry: 149 MB at BG1 Z=384 (bfloat16 would take 298 MB),
    cached per (config, device).  Stored column-major (a transposed view of
    a (P8, K8) tensor): the layout of the int8 tensor-core products, 6.7
    times faster than row-major at the flagship shape on an H100.  Pass it
    to ``encode_mxu``'s ``Gp``.
    """
    G = _parity_generator(params)
    K, P = G.shape
    out = torch.zeros(
        (_round_up(P, _SIZE_MULTIPLE), _round_up(K, _SIZE_MULTIPLE)),
        dtype=torch.int8,
    )
    out[:P, :K] = torch.from_numpy(G.T.astype(np.int8))
    return out.to(torch.device(device)).t()


def encode_mxu(
    params: LDPCParams, c: torch.Tensor, Gp: torch.Tensor | None = None
) -> torch.Tensor:
    """Matrix path: parity via one dense GF(2) matrix product.

    Bit-identical to ``encode`` (H c = 0 has a unique parity completion) but
    one (rows, K) x (K, P) product instead of ~700 rolled XORs.  Exact: int8
    0/1 operands through ``torch._int_mm``, which accumulates and returns
    int32 (sums <= K = 8448), then ``& 1``.  A bfloat16 or float16 product
    would round its sums before the parity is taken.

    Trades device memory for speed: Gp is K x P int8 (149 MB for BG1 Z=384),
    cached per config by ``parity_generator_device``.  Returns uint8
    (..., num_cols * Z) on the device of ``c``.
    """
    K = params.K
    P = (params.num_cols - params.num_sys_cols) * params.Z_c
    assert c.shape[-1] == K
    if Gp is None:
        Gp = parity_generator_device(params, c.device)
    assert Gp.shape == (_round_up(K, _SIZE_MULTIPLE), _round_up(P, _SIZE_MULTIPLE))
    lead = c.shape[:-1]
    x = c.reshape(-1, K).to(torch.int8)
    rows = x.shape[0]
    x = F.pad(x, (0, Gp.shape[0] - K, 0, max(_MIN_ROWS - rows, 0)))
    acc = torch._int_mm(x, Gp)[:rows, :P]
    par = (acc & 1).to(torch.uint8)
    return torch.cat([c.to(torch.uint8), par.reshape(lead + (P,))], dim=-1)


def syndrome(params: LDPCParams, cw: torch.Tensor) -> torch.Tensor:
    """H @ cw over GF(2): (..., num_cols*Z) -> (..., num_rows*Z).

    Used by tests (every codeword must satisfy H c = 0).
    """
    Z = params.Z_c
    rows, cols, shifts = params.edges
    u8 = cw.to(torch.uint8)
    blocks = u8.reshape(u8.shape[:-1] + (params.num_cols, Z))

    per_row: List[List[Tuple[int, int]]] = [[] for _ in range(params.num_rows)]
    for r, c, s in zip(rows, cols, shifts):
        per_row[int(r)].append((int(c), int(s)))

    syn = torch.stack([_xor_rotated(blocks, terms) for terms in per_row], dim=-2)
    return syn.reshape(u8.shape[:-1] + (params.num_rows * Z,))
