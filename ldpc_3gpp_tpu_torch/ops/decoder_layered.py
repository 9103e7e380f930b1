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

All three check rules (sum-product, min-sum, offset-min-sum) come from
``decoder_fast._check_messages``, shared with the flooding schedule.

``compress_row`` and ``expand_row`` model, for the tests, the compressed
words in which the CUDA kernel keeps the min-sum family's messages of a row
between sweeps (csrc/ldpc_bp.cuh); ``decode`` does not use them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spec.params import LDPCParams
from .decoder import DecodeResult
from .decoder_fast import (
    ALGORITHMS,
    _alpha_at,
    _check_messages,
    _row_plan,
    _syndrome_ok,
    require_algorithm,
    resolve_message_dtype,
)


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
    message_dtype: str = "float32",
) -> DecodeResult:
    """Layered BP decode of (..., num_cols*Z) LLRs on the device of ``llr``.

    ``layer_order`` ('reversed' default / 'natural' / explicit tuple) is the
    row processing order, shared with the CUDA kernel.

    ``alpha_schedule=(alpha0, n0)`` (min-sum only): normalization alpha0
    for the first n0 update sweeps, the standard ``alpha`` after.

    ``message_dtype='bfloat16'`` (min-sum family only) follows the CUDA
    kernel: only the stored message is rounded; the totals take the
    unrounded float32 message and the next sweep subtracts the rounded one.

    Returns int8 bits (..., num_cols*Z), bool parity_ok and int32 iterations.
    """
    if alpha_schedule is not None and algorithm != "min-sum":
        raise ValueError("alpha_schedule applies to min-sum only")
    require_algorithm(algorithm)
    dtype = resolve_message_dtype(message_dtype, algorithm)
    # beta (like alpha) meets the messages as an f32 value, rounded once.
    beta = float(np.float32(beta))

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
    c2v = [torch.zeros(batch_shape + (Z,), dtype=dtype, device=dev)
           for _ in range(E)]

    def update_sweep(it, keep):
        """One sweep; ``keep`` (..., 1) freezes codewords (None: none frozen).

        Returns the (...,) flags "every row's on-the-fly parity was even".
        """
        sweep_ok = None
        a_t = _alpha_at(alpha, alpha_schedule, it)
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
            v = [te - c2v[e].to(torch.float32)
                 for te, (e, _, _) in zip(t, edges)]
            nm = _check_messages(v, algorithm, a_t, beta)
            for i, (ve, (e, c, s)) in enumerate(zip(v, edges)):
                if keep is None:
                    c2v[e] = nm[i].to(dtype)
                    tn = ve + nm[i]
                else:
                    c2v[e] = torch.where(keep, c2v[e], nm[i].to(dtype))
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


# Bit positions of the compressed words (csrc/ldpc_bp.cuh): sign bits of the
# row's v_i in bits 0..deg-1 of ``meta``, the index of the first edge at the
# smallest magnitude in bits MSG_IDX_SHIFT..31.
MSG_IDX_SHIFT = 27
_SIGN = -(1 << 31)  # the sign bit of an int32
_MAG = (1 << 31) - 1


def compress_row(v, algorithm, alpha, beta, message_dtype="float32"):
    """The compressed words of one check row of the layered min-sum family.

    ``v``: the row's variable-to-check values, a list of (..., Z) float32
    tensors in edge order; ``alpha`` and ``beta`` as ``_check_messages``
    takes them (f32 values).  Returns int32 tensors (m1s, m2s, meta): the
    float32 bits of the scaled (min-sum) or offset (offset-min-sum) two
    smallest magnitudes with the row's sign product folded in, each rounded
    to bfloat16 for ``message_dtype='bfloat16'``, and the meta word.
    Magnitudes are compared as integers and signs are XORs of sign bits, as
    in the kernel.
    """
    if algorithm not in ("min-sum", "offset-min-sum"):
        raise ValueError("the compressed form is for the min-sum family")
    dtype = resolve_message_dtype(message_dtype, algorithm)
    bits = [ve.contiguous().view(torch.int32) for ve in v]
    mags = [b & _MAG for b in bits]
    m1, m2 = mags[0], torch.full_like(mags[0], 0x7F7FFFFF)
    idx = torch.zeros_like(m1)
    sx = bits[0]
    meta = (bits[0] >> 31) & 1
    for i in range(1, len(v)):
        idx = torch.where(mags[i] < m1, i, idx)
        m2 = torch.minimum(m2, torch.maximum(m1, mags[i]))
        m1 = torch.minimum(m1, mags[i])
        sx = sx ^ bits[i]
        meta = meta | (((bits[i] >> 31) & 1) << i)
    m1f, m2f = m1.view(torch.float32), m2.view(torch.float32)
    if algorithm == "min-sum":
        m1f, m2f = alpha * m1f, alpha * m2f
    else:
        m1f = torch.clamp_min(m1f - beta, 0.0)
        m2f = torch.clamp_min(m2f - beta, 0.0)
    ssign = sx & _SIGN
    words = []
    for m in (m1f, m2f):
        m = m.to(dtype).to(torch.float32)  # bf16(m ^ s) == bf16(m) ^ s
        words.append(m.view(torch.int32) ^ ssign)
    return words[0], words[1], meta | (idx << MSG_IDX_SHIFT)


def expand_row(m1s, m2s, meta, deg):
    """The ``deg`` float32 messages of a row from its compressed words:
    edge i gets m2s if it is the row's min index, else m1s, with the sign
    bit of its v_i flipped in."""
    idx = (meta >> MSG_IDX_SHIFT) & 31
    return [(torch.where(idx == i, m2s, m1s) ^ (((meta >> i) & 1) << 31))
            .view(torch.float32) for i in range(deg)]
