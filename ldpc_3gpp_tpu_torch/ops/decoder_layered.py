"""Layered-schedule BP decoder in plain PyTorch.

The plain version of the CUDA kernel's arithmetic (csrc/ldpc_layered.cu) and
the path CPU tensors take: the layered schedule updates the posterior totals
in place after every check row, which roughly halves the iterations needed
for a given BLER versus flooding.  It is written with ordinary tensor
operations (``torch.roll`` rotations with static shifts, per-row scans over
each base row's edge list, a Python loop over sweeps) so that the kernel's
trajectories can be cross-checked against an independent implementation on
any device.

Semantics match the kernel sweep for sweep: per-row syndrome of the current
totals accumulates during the sweep; a codeword whose every row passed
freezes (its totals and messages stop updating) and reports the sweep index
at which it passed; the final permitted sweep (it == iterations) only
checks, never updates (max ``iterations`` update sweeps, matching
comm.LDPCDecoder counting — NRLDPCDecoder.m:120).

Still to port (ROADMAP.md): the sum-product check rule.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spec.params import LDPCParams
from .decoder import DecodeResult
from .decoder_fast import _row_plan

ALGORITHMS = ("min-sum", "offset-min-sum")


def _resolve_layer_order(params: LDPCParams, layer_order):
    """Normalize the layered processing order to a concrete row tuple.

    'reversed' (the default) processes check rows last-to-first: the
    low-degree extension rows settle their parity columns before the dense
    core rows re-read them, which takes fewer sweeps to converge than the
    natural order.  'natural' is ascending row index; an explicit
    permutation tuple is taken as given.
    """
    nr = params.num_rows
    if layer_order == "natural":
        return tuple(range(nr))
    if layer_order == "reversed":
        return tuple(range(nr - 1, -1, -1))
    order = tuple(int(r) for r in layer_order)
    if sorted(order) != list(range(nr)):
        raise ValueError(f"layer_order must permute 0..{nr - 1}")
    return order


def _sign(x):
    # 0 maps to +1: the rule the kernel's sign-bit arithmetic follows, since
    # no -0.0 arises (channel zeros are +0.0).
    return torch.where(x < 0, -1.0, 1.0)


def require_algorithm(algorithm: str) -> None:
    """Raise unless ``algorithm`` is a check rule the port has."""
    if algorithm == "sum-product":
        raise NotImplementedError(
            "layered sum-product is not ported yet (ROADMAP.md queue B: V2)"
        )
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unsupported algorithm {algorithm}")


def _check_messages(v, algorithm, alpha, beta):
    """Extrinsic messages for one check row (mirrors the kernel's rule)."""
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
    layer_order="reversed",
    alpha_schedule=None,
) -> DecodeResult:
    """Layered BP decode of (..., num_cols*Z) LLRs on the device of ``llr``.

    ``layer_order`` ('reversed' default / 'natural' / explicit tuple) is the
    row processing order, shared with the CUDA kernel.

    ``alpha_schedule=(alpha0, n0)`` (min-sum only): normalization alpha0
    for the first n0 update sweeps, the standard ``alpha`` after.

    Returns int8 bits (..., num_cols*Z), bool parity_ok and int32 iterations.
    """
    if alpha_schedule is not None and algorithm != "min-sum":
        raise ValueError("alpha_schedule applies to min-sum only")
    require_algorithm(algorithm)
    # alpha and beta meet the messages as f32 values, rounded once here.
    alpha, beta = float(np.float32(alpha)), float(np.float32(beta))

    def _alpha_at(it):
        if alpha_schedule is None:
            return alpha
        a0, n0 = alpha_schedule
        return float(np.float32(a0)) if it < n0 else alpha

    row_seq = _resolve_layer_order(params, layer_order)
    Z = params.Z_c
    nc = params.num_cols
    assert llr.shape[-1] == nc * Z
    batch_shape = llr.shape[:-1]
    dev = llr.device
    blocks = llr.to(torch.float32).reshape(batch_shape + (nc, Z))
    # Per-column / per-edge lists of (..., Z) tensors, rebound as rows update
    # them (no copy of the whole state per update).
    totals = [blocks[..., c, :] for c in range(nc)]
    by_row, _ = _row_plan(params)
    E = len(params.edges[0])
    c2v = [torch.zeros(batch_shape + (Z,), dtype=torch.float32, device=dev)
           for _ in range(E)]

    def update_sweep(it, keep):
        """One sweep; ``keep`` (..., 1) freezes codewords (None: none frozen).

        Returns the (...,) flags "every row's on-the-fly parity was even".
        """
        sweep_ok = None
        a_t = _alpha_at(it)
        for r in row_seq:
            edges = by_row[r]
            t = [torch.roll(totals[c], -s, dims=-1) for (_, c, s) in edges]
            if early_termination:
                par = None
                for te in t:
                    bit = te < 0
                    par = bit if par is None else par ^ bit
                row_ok = ~par.any(dim=-1)
                sweep_ok = row_ok if sweep_ok is None else sweep_ok & row_ok
            v = [te - c2v[e] for te, (e, _, _) in zip(t, edges)]
            nm = _check_messages(v, algorithm, a_t, beta)
            for i, (ve, (e, c, s)) in enumerate(zip(v, edges)):
                if keep is None:
                    c2v[e] = nm[i]
                    tn = ve + nm[i]
                else:
                    c2v[e] = torch.where(keep, c2v[e], nm[i])
                    tn = torch.where(keep, t[i], ve + nm[i])
                totals[c] = torch.roll(tn, s, dims=-1)
        return sweep_ok

    if early_termination:
        done = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
        used = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
        it = 0
        # The loop condition reads `done` on the host once per sweep.
        while it <= iterations and not bool(done.all()):
            if it < iterations:
                sweep_ok = update_sweep(it, done.unsqueeze(-1))
            else:
                # final permitted sweep: check the settled totals only
                sweep_ok = _syndrome_ok(totals, by_row, row_seq)
            newly = sweep_ok & ~done
            used = torch.where(newly, it, used).to(torch.int32)
            done = done | sweep_ok
            it += 1
        used = torch.where(done, used, iterations).to(torch.int32)
    else:
        # Run-to-budget semantics: exactly `iterations` update sweeps with no
        # freezing, bits from the final totals, parity flag = the clean
        # syndrome of that settled final state.
        for it in range(iterations):
            update_sweep(it, None)
        done = _syndrome_ok(totals, by_row, row_seq)
        used = torch.full(batch_shape, iterations, dtype=torch.int32, device=dev)

    bits = (torch.stack(totals, dim=-2) < 0).reshape(batch_shape + (nc * Z,))
    return DecodeResult(bits=bits.to(torch.int8), parity_ok=done, iterations=used)
