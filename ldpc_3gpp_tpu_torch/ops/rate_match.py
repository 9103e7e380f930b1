"""Rate matching (TS38.212 Sections 5.4.2.1-5.4.2.2) without gathers.

The reference implements bit selection as a per-bit ``while`` loop that walks
the circular buffer skipping NaN filler positions (NRLDPCEncoder.m:187-195,
NRLDPCDecoder.m:226-234).  Filler positions are statically known from the
code parameters AND contiguous (one range [lo, hi) inside d), so the walk is
affine piecewise: one cycle of the buffer emits the non-filler positions
``[0, lo) ++ [hi, N_cb)`` rotated to start at k_0.  That makes both
directions compositions of static slices, concats, and rolls — no gather and
no scatter:

- encoder:  e = tile(roll(concat(d[:lo], d[hi:N_cb]), -r), reps)[:E]
- decoder:  the scatter-add the reference implies (NRLDPCDecoder.m:228-234)
  is a sum over the repetition axis (the LLR Chase combining), the inverse
  roll, and re-inserting zeros for the filler hole and the never-transmitted
  tail.

``selection_indices`` (the explicit index vector) is kept as the test oracle.
The Section 5.4.2.2 bit interleaver is a reshape/transpose.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..spec.params import LDPCParams


@functools.lru_cache(maxsize=None)
def selection_indices(params: LDPCParams, E: int) -> np.ndarray:
    """Indices into d (length N) read by bit selection for one code block.

    Implements the NaN-skipping circular read from k_0 (NRLDPCEncoder.m:187-195):
    position p = (k_0 + j) mod N_cb is emitted unless p is a filler position.
    Repetition (E larger than one buffer cycle) wraps naturally.
    """
    lo, hi = params.filler_range_d
    k0, N_cb = params.k_0, params.N_cb
    # One full cycle of non-filler positions starting at k0.
    offsets = (k0 + np.arange(N_cb)) % N_cb
    cycle = offsets[(offsets < lo) | (offsets >= hi)]
    assert cycle.size > 0, "no transmittable positions in circular buffer"
    reps = -(-E // cycle.size)
    return np.tile(cycle, reps)[:E].astype(np.int32)


def interleave(e: torch.Tensor, Q_m: int) -> torch.Tensor:
    """Section 5.4.2.2 interleaver: f[i + j*Q_m] = e[i*(E/Q_m) + j].

    (NRLDPCEncoder.m:219-223.)  e: (..., E) with E % Q_m == 0.
    """
    E = e.shape[-1]
    rows = e.reshape(e.shape[:-1] + (Q_m, E // Q_m))
    return rows.transpose(-1, -2).reshape(e.shape[:-1] + (E,))


def deinterleave(f: torch.Tensor, Q_m: int) -> torch.Tensor:
    """Inverse of ``interleave`` (NRLDPCDecoder.m:191-195)."""
    E = f.shape[-1]
    cols = f.reshape(f.shape[:-1] + (E // Q_m, Q_m))
    return cols.transpose(-1, -2).reshape(f.shape[:-1] + (E,))


@functools.lru_cache(maxsize=None)
def _cycle_geometry(params: LDPCParams) -> Tuple[int, int, int, int]:
    """(lo, hi, M, r): filler hole clipped to N_cb, cycle length, start rank.

    Sorted non-filler buffer positions are S = [0, lo) ++ [hi, N_cb), with
    ``rank(p) = p if p < lo else p - (hi - lo)``; one selection cycle is S
    rotated to start at the first non-filler position at-or-after k_0, i.e.
    at rank ``r``.
    """
    lo, hi = params.filler_range_d
    k0, N_cb = params.k_0, params.N_cb
    lo, hi = min(lo, N_cb), min(hi, N_cb)
    M = N_cb - (hi - lo)
    assert M > 0, "no transmittable positions in circular buffer"
    assert 0 <= k0 < N_cb
    if k0 < lo:
        r = k0
    elif k0 < hi:
        r = lo  # k_0 inside the filler hole: first emission is position hi
    else:
        r = k0 - (hi - lo)
    return lo, hi, M, r


def select_bits(params: LDPCParams, d: torch.Tensor, E: int) -> torch.Tensor:
    """Encoder bit selection: d (..., N) -> e (..., E).  Slices + roll only."""
    lo, hi, M, r = _cycle_geometry(params)
    N_cb = params.N_cb
    buf = torch.cat([d[..., :lo], d[..., hi:N_cb]], dim=-1)
    if r:
        buf = torch.roll(buf, -r, dims=-1)
    reps = -(-E // M)
    if reps > 1:
        buf = buf.repeat((1,) * (buf.ndim - 1) + (reps,))
    return buf[..., :E]


def accumulate_llrs(params: LDPCParams, e_tilde: torch.Tensor, E: int) -> torch.Tensor:
    """Decoder bit selection: accumulate rate-matched LLRs into the buffer.

    e_tilde: (..., E) -> d_tilde (..., N).  Repeated positions accumulate
    (Chase combining, NRLDPCDecoder.m:228-234).  Filler positions and the
    never-transmitted tail beyond N_cb receive zero; the chain later pins
    fillers to a large positive LLR (known zero bits).

    Equivalent to ``zeros(N).index_add_(selection_indices, e_tilde)`` but
    with no scatter and no gather: sum over the circular-buffer repetition
    axis (the Chase combine), undo the k_0 rotation, and re-insert the zero
    ranges by concat.
    """
    lo, hi, M, r = _cycle_geometry(params)
    lead = e_tilde.shape[:-1]
    reps = -(-E // M)
    pad = reps * M - E
    if pad:
        e_tilde = F.pad(e_tilde, (0, pad))
    if reps > 1:
        # Explicit left-to-right sum over the repetition axis: the order the
        # JAX package's reduction takes on the CPU, so the f32 sums agree
        # bit for bit (a library reduction may pair the terms differently).
        rep = e_tilde.reshape(lead + (reps, M))
        acc = rep[..., 0, :]
        for k in range(1, reps):
            acc = acc + rep[..., k, :]
    else:
        acc = e_tilde
    if r:
        acc = torch.roll(acc, r, dims=-1)  # acc[rank(p)] now belongs to p
    zeros = functools.partial(torch.zeros, dtype=acc.dtype, device=acc.device)
    parts = [acc[..., :lo]]
    if hi > lo:
        parts.append(zeros(lead + (hi - lo,)))
    parts.append(acc[..., lo:])
    if params.N > params.N_cb:
        parts.append(zeros(lead + (params.N - params.N_cb,)))
    return torch.cat(parts, dim=-1)
