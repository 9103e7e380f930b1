"""Small lifting sizes on the card: codewords per block and routing.

Two tables behind two decisions of ``ops/decoder_cuda.py``:

- ``packing_table``: microseconds per codeword of the BP kernels by lifting
  size Z, codewords per block P, batch n and schedule, on the same LLRs for
  every P.  ``auto_codewords_per_block`` is derived from it.
- ``routing_table``: the kernel (with its best P) against the plain PyTorch
  decoders of backend 'fast' on the card, Z = 2..16, same inputs.
  ``supports`` (what backend 'auto' sends to the kernels) is derived from it.

    python3 -m ldpc_3gpp_tpu_torch.tools.small_z

prints both as JSON lines with the card's name and power limit.  Needs a CUDA
device.  Min-sum, 8 iterations, early termination, 'd' input and 'sys'
output, rate 1/3 QPSK at 1.0 dB (a mix of sweeps to convergence); a third
table repeats the packing measurement at a 50-iteration budget at 1.0 and
3.0 dB.
"""
from __future__ import annotations

import functools
import json
import sys

import torch

from ..models.decoder import split_rate_matched_symbols
from ..models.encoder import encode_to_symbols
from ..ops import decoder_cuda, decoder_fast, decoder_layered
from ..ops.channel import complex_noise, esn0_to_variance
from ..spec.params import LDPCParams
from ..spec.tables import UnsupportedParameters
from .op_rates import card_name_and_power_limit, time_ms

ITERATIONS = 8
ESN0_DB = 1.0
PACKING_ZS = (2, 8, 20, 48, 96, 144, 208)
PACKING_PS = (1, 2, 4, 8, 16)
PACKING_NS = (256, 2048, 4096, 16384)
ROUTING_ZS = tuple(range(2, 17))
ROUTING_NS = (256, 2048)
DECODE_KW = dict(iterations=ITERATIONS, algorithm="min-sum",
                 channel_format="d", output_format="sys")


@functools.lru_cache(maxsize=None)
def params_for_z(bg: int, Z: int, q_m: int = 2, rate: float = 1 / 3) -> LDPCParams:
    """The longest single-code-block configuration of base graph ``bg``
    whose lifting size is ``Z`` (G = A / rate rounded to whole symbols)."""
    found = None
    for A in range(1, 8425):
        G = max(round(A / rate / q_m), 1) * q_m
        try:
            p = LDPCParams(BG=bg, A=A, G=G, Q_m=q_m)
        except UnsupportedParameters:
            continue
        if p.C == 1 and p.Z_c == Z:
            found = p
    if found is None:
        raise ValueError(f"no single-code-block configuration of BG{bg} has Z={Z}")
    return found


def table_params(Z: int) -> LDPCParams:
    """The tables' code at lifting size ``Z``: base graph 2, or base graph 1
    where base graph 2 has no such size (Z = 2)."""
    try:
        return params_for_z(2, Z)
    except ValueError:
        return params_for_z(1, Z)


def noisy_llrs(params: LDPCParams, n: int, esn0_db: float, seed: int, device):
    """(n, N) circular-buffer LLRs ('d' format) of random blocks through the
    port's encode / AWGN / demodulate chain, drawn on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    modulation = {1: "BPSK", 2: "QPSK", 4: "16QAM", 6: "64QAM", 8: "256QAM"}[params.Q_m]
    a = torch.randint(0, 2, (n, params.A), generator=g, device=device, dtype=torch.int8)
    noise_var = esn0_to_variance(esn0_db, device=device)
    tx = encode_to_symbols(params, a, modulation)
    rx = tx + complex_noise(g, tx.shape, noise_var, device)
    return split_rate_matched_symbols(params, rx, modulation, noise_var)[:, 0]


def fitting_ps(params: LDPCParams, schedule: str, ps=PACKING_PS):
    return [P for P in ps if decoder_cuda._fits(schedule, params, P)]


def packing_table(device, zs=PACKING_ZS, ps=PACKING_PS, ns=PACKING_NS,
                  schedules=decoder_cuda.SCHEDULES, iterations=ITERATIONS,
                  esn0_db=ESN0_DB):
    """One record per (Z, schedule, n): microseconds per codeword for every P
    that fits, the best P and the automatic choice."""
    rows = []
    kw = dict(DECODE_KW, iterations=iterations)
    for Z in zs:
        params = table_params(Z)
        llr = noisy_llrs(params, max(ns), esn0_db, 100 + Z, device)
        for schedule in schedules:
            fit = fitting_ps(params, schedule, ps)
            occupancy = {P: decoder_cuda.blocks_per_sm(
                params, schedule, codewords_per_block=P) for P in fit}
            for n in ns:
                x = llr[:n]
                reps = max(3, min(30, 32768 // n))
                us = {}
                for P in fit:
                    fn = lambda: decoder_cuda.decode(
                        params, x, schedule=schedule, codewords_per_block=P, **kw)
                    us[P] = time_ms(fn, reps) * 1e3 / n
                res = decoder_cuda.decode(params, x, schedule=schedule, **kw)
                rows.append({
                    "bg": params.BG, "Z": Z, "A": params.A, "schedule": schedule, "n": n,
                    "iterations": iterations, "esn0_db": esn0_db,
                    "passed": float(res.parity_ok.float().mean()),
                    "us_per_codeword": us, "blocks_per_sm": occupancy,
                    "best_P": min(us, key=us.get),
                    "auto_P": decoder_cuda.auto_codewords_per_block(params, n, schedule),
                    "mean_iterations": float(res.iterations.float().mean()),
                })
    return rows


def routing_table(device, zs=ROUTING_ZS, ns=ROUTING_NS,
                  schedules=decoder_cuda.SCHEDULES):
    """One record per (Z, schedule, n): milliseconds of the kernel with its
    best P and of the plain decoder of backend 'fast', on the same LLRs."""
    plain = {"layered": decoder_layered.decode, "flooding": decoder_fast.decode}
    rows = []
    for Z in zs:
        params = table_params(Z)
        d = noisy_llrs(params, max(ns), ESN0_DB, 200 + Z, device)
        cw = torch.cat([torch.zeros(d.shape[0], 2 * Z, device=device), d], dim=-1)
        lo, hi = params.filler_range_d
        cw[:, 2 * Z + lo : 2 * Z + hi] = decoder_cuda.FILLER_LLR
        for schedule in schedules:
            for n in ns:
                kernel_ms = {}
                for P in fitting_ps(params, schedule):
                    fn = lambda: decoder_cuda.decode(
                        params, d[:n], schedule=schedule, codewords_per_block=P, **DECODE_KW)
                    kernel_ms[P] = time_ms(fn, 10)
                best = min(kernel_ms, key=kernel_ms.get)
                plain_ms = time_ms(lambda: plain[schedule](
                    params, cw[:n], iterations=ITERATIONS, algorithm="min-sum"), 1)
                rows.append({
                    "bg": params.BG, "Z": Z, "schedule": schedule, "n": n,
                    "kernel_ms": kernel_ms[best], "kernel_P": best,
                    "kernel_ms_one_per_block": kernel_ms[1],
                    "plain_ms": plain_ms,
                    "kernel_wins": kernel_ms[best] < plain_ms,
                })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("small_z: no CUDA device; this tool measures a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_name_and_power_limit()
    for row in packing_table(device):
        print(json.dumps({"table": "packing", **row, "card": card}), flush=True)
    # a sweep's conditions: the reference's 50-iteration budget, below and
    # above the waterfall, where the codewords of a block stop far apart
    for esn0_db in (1.0, 3.0):
        for row in packing_table(device, zs=(2, 8, 20, 48), ns=(4096, 16384),
                                 iterations=50, esn0_db=esn0_db):
            print(json.dumps({"table": "packing_budget_50", **row, "card": card}),
                  flush=True)
    for row in routing_table(device):
        print(json.dumps({"table": "routing", **row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
