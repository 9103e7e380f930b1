"""Flooding-schedule BP decoder in plain PyTorch, and what it shares with
the layered one: the per-row edge plan and the check-node rule.

The plain version of the flooding CUDA kernel's arithmetic
(csrc/ldpc_flooding.cu) and the path CPU tensors take.  Every check row of
a sweep reads the same pre-sweep posterior totals; the new messages are
summed per column in ascending row order (the first edge of a column is
assigned, the rest are added) and the totals become ``llr + sum`` after the
sweep.  Written with ordinary tensor operations (``torch.roll`` rotations
with static shifts, per-row scans over each base row's edge list, a Python
loop over sweeps).

Semantics, sweep for sweep (comm.LDPCDecoder 'Parity check satisfied',
NRLDPCDecoder.m:120): pass ``it`` takes the syndrome of the totals it
reads, before its own update; a codeword's output is latched at the first
pass whose syndrome is zero and it reports ``iterations = it``; the pass at
``it == iterations`` only checks, so a codeword gets at most ``iterations``
updates; one that never passed reports ``iterations`` and its final totals.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..spec.params import LDPCParams
from .decoder import DecodeResult, _PHI_MIN, _phi

ALGORITHMS = ("min-sum", "offset-min-sum", "sum-product")
MESSAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _row_plan(params: LDPCParams):
    """Per-base-row edge lists [(edge_idx, col, shift)] and per-col lists."""
    rows, cols, shifts = params.edges
    by_row: List[List[Tuple[int, int, int]]] = [[] for _ in range(params.num_rows)]
    by_col: List[List[Tuple[int, int]]] = [[] for _ in range(params.num_cols)]
    for e, (r, c, s) in enumerate(zip(rows, cols, shifts)):
        by_row[int(r)].append((e, int(c), int(s)))
        by_col[int(c)].append((e, int(s)))
    return by_row, by_col


def require_algorithm(algorithm: str) -> None:
    """Raise unless ``algorithm`` is one of the three check rules."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unsupported algorithm {algorithm}")


def resolve_message_dtype(message_dtype: str, algorithm: str) -> torch.dtype:
    """The storage type of the check messages; bfloat16 is for the min-sum
    family only (sum-product stays float32 so that it stays bit-exact)."""
    if message_dtype not in MESSAGE_DTYPES:
        raise ValueError(f"unsupported message_dtype {message_dtype}")
    if message_dtype == "bfloat16" and algorithm == "sum-product":
        raise ValueError("sum-product requires message_dtype='float32'")
    return MESSAGE_DTYPES[message_dtype]


def _alpha_at(alpha, alpha_schedule, it):
    """Normalization of update sweep ``it`` as an f32 value: ``alpha0`` for
    the first ``n0`` sweeps of a schedule ``(alpha0, n0)``, else ``alpha``."""
    if alpha_schedule is not None and it < alpha_schedule[1]:
        alpha = alpha_schedule[0]
    return float(np.float32(alpha))


def _sign(x):
    # 0 and -0.0 map to +1, as in the kernels.
    return torch.where(x < 0, -1.0, 1.0)


def _check_messages(v, algorithm, alpha, beta):
    """Extrinsic messages for one check row (mirrors the kernels' rule)."""
    if algorithm == "sum-product":
        # phi is elementwise: one call on the row's stacked edges gives each
        # edge the bits of its own call, with a fraction of the launches
        vs = torch.stack(v)
        phis = _phi(vs.abs())
        total = phis[0]
        for p in phis[1:]:
            total = total + p
        sprod = _sign(v[0])
        for ve in v[1:]:
            sprod = sprod * _sign(ve)
        out = sprod * _sign(vs) * _phi(torch.clamp_min(total - phis, _PHI_MIN))
        return list(out.unbind(0))
    m1 = v[0].abs()
    m2 = torch.full_like(m1, float("inf"))
    idx = torch.zeros_like(m1, dtype=torch.int32)
    sprod = _sign(v[0])
    for i in range(1, len(v)):
        av = v[i].abs()
        better = av < m1
        m2 = torch.where(better, m1, torch.minimum(m2, av))
        m1 = torch.where(better, av, m1)
        idx = torch.where(better, i, idx)
        sprod = sprod * _sign(v[i])
    if algorithm == "min-sum":
        m1 = alpha * m1
        m2 = alpha * m2
    else:
        m1 = torch.clamp_min(m1 - beta, 0.0)
        m2 = torch.clamp_min(m2 - beta, 0.0)
    return [
        sprod * _sign(ve) * torch.where(idx == i, m2, m1)
        for i, ve in enumerate(v)
    ]


def _syndrome_ok(totals, by_row, row_seq):
    """(...,) bool: every check of every row sees even sign parity."""
    ok = None
    for r in row_seq:
        par = None
        for (_, c, s) in by_row[r]:
            bit = torch.roll(totals[c], -s, dims=-1) < 0
            par = bit if par is None else par ^ bit
        row_ok = ~par.any(dim=-1)
        ok = row_ok if ok is None else ok & row_ok
    return ok


@torch.no_grad()
def decode(
    params: LDPCParams,
    llr: torch.Tensor,
    iterations: int = 50,
    algorithm: str = "min-sum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    early_termination: bool = True,
    alpha_schedule=None,
    message_dtype: str = "float32",
) -> DecodeResult:
    """Flooding BP decode of (..., num_cols*Z) LLRs on the device of ``llr``.

    ``alpha_schedule=(alpha0, n0)`` (min-sum only) and
    ``message_dtype='bfloat16'`` (min-sum family only) follow the CUDA
    kernel: with bfloat16 only the stored message is rounded; the column
    sums take the unrounded float32 message and the next sweep subtracts
    the rounded one.

    Returns int8 bits (..., num_cols*Z), bool parity_ok and int32 iterations.
    """
    require_algorithm(algorithm)
    if alpha_schedule is not None and algorithm != "min-sum":
        raise ValueError("alpha_schedule applies to min-sum only")
    dtype = resolve_message_dtype(message_dtype, algorithm)
    beta = float(np.float32(beta))

    Z = params.Z_c
    nc, nr = params.num_cols, params.num_rows
    assert llr.shape[-1] == nc * Z
    batch_shape = llr.shape[:-1]
    dev = llr.device
    blocks = llr.to(torch.float32).reshape(batch_shape + (nc, Z))
    llr_cols = [blocks[..., c, :] for c in range(nc)]
    by_row, _ = _row_plan(params)
    rows = range(nr)
    E = len(params.edges[0])
    c2v = [torch.zeros(batch_shape + (Z,), dtype=dtype, device=dev)
           for _ in range(E)]

    def update_sweep(it, totals, c2v):
        """One flooding update: (new totals, new messages)."""
        a_t = _alpha_at(alpha, alpha_schedule, it)
        new_c2v = [None] * E
        acc = [None] * nc
        for r in rows:
            edges = by_row[r]
            v = [torch.roll(totals[c], -s, dims=-1) - c2v[e].to(torch.float32)
                 for (e, c, s) in edges]
            nm = _check_messages(v, algorithm, a_t, beta)
            for m, (e, c, s) in zip(nm, edges):
                new_c2v[e] = m.to(dtype)
                back = torch.roll(m, s, dims=-1)
                acc[c] = back if acc[c] is None else acc[c] + back
        return [llr_cols[c] + acc[c] for c in range(nc)], new_c2v

    totals = llr_cols
    if early_termination:
        done = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
        used = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
        out = totals
        it = 0
        while True:
            ok = _syndrome_ok(totals, by_row, rows)  # of the pre-update totals
            newly = (ok & ~done).unsqueeze(-1)
            out = [torch.where(newly, t, o) for t, o in zip(totals, out)]
            used = torch.where(newly[..., 0], it, used).to(torch.int32)
            done = done | ok
            # `done` is read on the host once per sweep
            if it == iterations or bool(done.all()):
                break
            totals, c2v = update_sweep(it, totals, c2v)
            it += 1
        # codewords that never satisfied parity keep their final totals
        keep = done.unsqueeze(-1)
        out = [torch.where(keep, o, t) for t, o in zip(totals, out)]
        used = torch.where(done, used, iterations).to(torch.int32)
    else:
        # Run to budget: exactly `iterations` updates, bits from the final
        # totals, parity flag = the syndrome of that final state.
        for it in range(iterations):
            totals, c2v = update_sweep(it, totals, c2v)
        out = totals
        done = _syndrome_ok(totals, by_row, rows)
        used = torch.full(batch_shape, iterations, dtype=torch.int32, device=dev)

    bits = (torch.stack(out, dim=-2) < 0).reshape(batch_shape + (nc * Z,))
    return DecodeResult(bits=bits.to(torch.int8), parity_ok=done, iterations=used)
