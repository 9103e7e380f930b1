"""Flooding belief-propagation decoder over segment operations (the
correctness oracle of the flooding paths), the shared decoder result type,
the constants and the sum-product ``phi``.

LLR convention: positive LLR => bit 0 (MATLAB comm convention; fillers are
pinned to a large positive LLR by the caller, NRLDPCDecoder.m:264).

``_phi`` is evaluated by an explicit recipe of float32 operations instead of
``torch.tanh`` / ``torch.log``: the recipe reproduces, bit for bit, the
float32 ``tanh`` and ``log`` the JAX package's CPU path evaluates, so a
sum-product decode is held equal to it at tolerance 0 like the min-sum
family.  Library calls round differently (most visibly where ``tanh``
saturates to 1: phi is -0.0 by the recipe), and the CUDA kernels carry the
same recipe as a device function.

``decode`` keeps every message in the BASE-GRAPH edge domain: an edge
(r, c, s) carries a (batch, Z) block, check (r, z) connects to variable
(c, (z+s) mod Z), and the per-check and per-column reductions are segment
operations over the static edge->row and edge->column maps.  Its sums are
gathers through padded (segments, max degree) edge tables, added left to
right in edge order from zero: the order of the JAX package's segment sums
on the CPU, and the same order on every device (a scatter-add on CUDA uses
atomics, whose order changes from run to run).
"""
from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
def _edge_maps(params):
    """Static gather/segment tables for the edge-domain message passing."""
    rows, cols, shifts = params.edges
    Z = params.Z_c
    E = len(rows)
    z = np.arange(Z)
    # variable -> check coordinates: check (r, z) sees variable (c, (z+s)%Z)
    fwd = (z[None, :] + shifts[:, None]) % Z  # (E, Z)
    # check -> variable coordinates: variable (c, j) hears check (r, (j-s)%Z)
    bwd = (z[None, :] - shifts[:, None]) % Z  # (E, Z)
    # Flat gather index into total (..., num_cols*Z) for the forward pass.
    flat_fwd = cols[:, None] * Z + fwd
    return (
        rows.astype(np.int32),
        cols.astype(np.int32),
        flat_fwd.astype(np.int32),
        bwd.astype(np.int32),
        E,
    )


def _segment_table(ids: np.ndarray, num_segments: int) -> np.ndarray:
    """(num_segments, max degree) edge indices of each segment in edge
    order; the padding points at edge E, a slot the caller fills with the
    reduction's identity."""
    members = [np.nonzero(ids == s)[0] for s in range(num_segments)]
    out = np.full((num_segments, max(len(m) for m in members)), len(ids), np.int64)
    for s, m in enumerate(members):
        out[s, : len(m)] = m
    return out


@functools.lru_cache(maxsize=8)
def _device_maps(params, device):
    """``_edge_maps`` and the row and column tables as tensors on ``device``."""
    row_ids, col_ids, flat_fwd, bwd, E = _edge_maps(params)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    return (
        t(row_ids), t(flat_fwd), t(bwd),
        t(_segment_table(row_ids, params.num_rows)),
        t(_segment_table(col_ids, params.num_cols)),
    )


def _segment_sum(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(E, ...) -> (segments, ...): each segment's members summed left to
    right in edge order, starting from zero."""
    xp = torch.cat([x, torch.zeros_like(x[:1])])
    acc = torch.zeros((table.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    for j in range(table.shape[1]):
        acc = acc + xp[table[:, j]]
    return acc


def _segment_min(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(E, ...) -> (segments, ...): each segment's minimum."""
    xp = torch.cat([x, torch.full_like(x[:1], float("inf"))])
    acc = xp[table[:, 0]]
    for j in range(1, table.shape[1]):
        acc = torch.minimum(acc, xp[table[:, j]])
    return acc


def _check_update(v2c, row_ids, row_table, algorithm, alpha, beta):
    """Per-check extrinsic messages. v2c: (E, ..., Z) in check coordinates."""
    sign_bit = (v2c < 0).to(torch.float32)  # 1 = negative
    mag = v2c.abs()

    par = _segment_sum(sign_bit, row_table)
    excl_sign_bit = torch.remainder(par[row_ids] - sign_bit, 2.0)
    sign = 1.0 - 2.0 * excl_sign_bit

    if algorithm == "sum-product":
        t = _phi(mag)
        T = _segment_sum(t, row_table)
        excl = torch.clamp_min(T[row_ids] - t, _c(_PHI_MIN))
        out_mag = _phi(excl)
    elif algorithm in ("min-sum", "offset-min-sum"):
        m1 = _segment_min(mag, row_table)
        is_min = mag <= m1[row_ids]
        cnt = _segment_sum(is_min.to(torch.float32), row_table)
        m2 = _segment_min(torch.where(is_min, _c(_INF), mag), row_table)
        # Exclusive min: the unique minimum edge sees the second-best.
        excl = torch.where(
            is_min & (cnt[row_ids] <= 1.0), m2[row_ids], m1[row_ids]
        )
        if algorithm == "min-sum":
            out_mag = _c(alpha) * excl
        else:
            out_mag = torch.clamp_min(excl - _c(beta), 0.0)
    else:
        raise ValueError(f"unsupported algorithm {algorithm}")

    return sign * out_mag


@torch.no_grad()
def decode(
    params,
    llr: torch.Tensor,
    iterations: int = 50,
    algorithm: str = "sum-product",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
) -> DecodeResult:
    """Decode (..., num_cols*Z) channel LLRs on the device of ``llr``.

    Matches comm.LDPCDecoder semantics: flooding schedule, at most
    ``iterations`` iterations, stopping early per-codeword once the hard
    decisions satisfy every parity check (NRLDPCDecoder.m:120).  Terminated
    codewords are frozen while the rest of the batch continues (masked
    termination).  Returns int8 bits, bool parity_ok and int32 iterations.
    """
    Z = params.Z_c
    nc = params.num_cols
    ncZ = nc * Z
    assert llr.shape[-1] == ncZ
    dev = llr.device
    row_ids, flat_fwd, bwd, row_table, col_table = _device_maps(params, dev)
    E = row_ids.shape[0]

    batch_shape = tuple(llr.shape[:-1])
    llr = llr.to(torch.float32)
    bwd_b = bwd.reshape((E,) + (1,) * len(batch_shape) + (Z,)).expand(
        (E,) + batch_shape + (Z,))

    def gather_fwd(total):
        # total: (..., ncZ) -> v2c input (E, ..., Z) in check coordinates
        return torch.movedim(total[..., flat_fwd], -2, 0)

    def syndrome_ok(total):
        par = _segment_sum(gather_fwd((total < 0).to(torch.float32)), row_table)
        ok = torch.remainder(par, 2.0) < 0.5  # (rows, ..., Z)
        return ok.all(dim=-1).all(dim=0)  # (...,)

    def vn_update(c2v):
        # c2v: (E, ..., Z) check coords -> variable coords, summed by column
        acc = _segment_sum(torch.gather(c2v, -1, bwd_b), col_table)
        # (num_cols, ..., Z) -> (..., ncZ)
        return llr + torch.movedim(acc, 0, -2).reshape(batch_shape + (ncZ,))

    c2v = torch.zeros((E,) + batch_shape + (Z,), dtype=torch.float32, device=dev)
    total = llr
    if early_termination:
        done = syndrome_ok(total)
    else:
        done = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
    used = torch.zeros(batch_shape, dtype=torch.int32, device=dev)

    it = 0
    # `done` is read on the host once per iteration
    while it < iterations and not bool(done.all()):
        v2c = gather_fwd(total) - c2v
        c2v_new = _check_update(v2c, row_ids, row_table, algorithm, alpha, beta)
        total_new = vn_update(c2v_new)

        keep = done.reshape((1,) + batch_shape + (1,))
        c2v = torch.where(keep, c2v, c2v_new)
        total = torch.where(done.unsqueeze(-1), total, total_new)
        used = torch.where(done, used, it + 1).to(torch.int32)
        if early_termination:
            done = done | syndrome_ok(total)
        it += 1

    parity_ok = done if early_termination else syndrome_ok(total)
    bits = (total < 0).to(torch.int8)
    return DecodeResult(bits=bits, parity_ok=parity_ok, iterations=used)
