"""Small lifting sizes on the card: codewords per block and routing.

Two tables behind two decisions of ``ops/decoder_cuda.py``:

- ``packing_table``: microseconds per codeword of the BP kernels by lifting
  size Z, codewords per block P, batch n, schedule and (layered) message
  type, on the same LLRs for every P.  ``auto_codewords_per_block`` is
  derived from it.
- ``routing_table``: the kernel (with its best P) against the plain PyTorch
  decoders of backend 'fast' on the card, Z = 2..16, same inputs.
  ``supports`` (what backend 'auto' sends to the kernels) is derived from it.

    python3 -m ldpc_3gpp_tpu_torch.tools.small_z [packing | split]

prints both as JSON lines with the card's name and power limit (with
``packing``, the packing tables only; with ``split``, ``launch_split``
only: each launch's time on the card and on the host apart).  Needs a CUDA
device.  Min-sum, 8 iterations, early termination, 'd' input and 'sys'
output, rate 1/3 QPSK at 1.0 dB (a mix of sweeps to convergence); a third
table repeats the packing measurement at a 50-iteration budget at 1.0 and
3.0 dB.
"""
from __future__ import annotations

import functools
import json
import sys
import time

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
PACKING_ZS = (2, 5, 8, 13, 20, 26, 32, 48, 96, 144, 208)
# codewords per block: up to 64 for the layered warp form (a block of up to
# 16 warps, 32 // Z codewords a warp), up to 16 for flooding
PACKING_PS = (1, 2, 4, 8, 16, 32, 64)
FLOODING_PS = (1, 2, 4, 8, 16)
PACKING_NS = (256, 2048, 4096, 16384)
# the layered rows' message types (flooding: float32)
PACKING_DTYPES = ("float32", "bfloat16")
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


def fitting_ps(params: LDPCParams, schedule: str, ps=None):
    """The codewords per block of ``ps`` (by default PACKING_PS, flooding
    FLOODING_PS) that fit a block of this code."""
    if ps is None:
        ps = PACKING_PS if schedule == "layered" else FLOODING_PS
    return [P for P in ps if decoder_cuda._fits(schedule, params, P)]


def packing_table(device, zs=PACKING_ZS, ps=PACKING_PS, ns=PACKING_NS,
                  schedules=decoder_cuda.SCHEDULES, iterations=ITERATIONS,
                  esn0_db=ESN0_DB, message_dtypes=PACKING_DTYPES):
    """One record per (Z, schedule, message type, n): microseconds per
    codeword for every P that fits and for the automatic choice, the best P
    and the automatic choice."""
    rows = []
    for Z in zs:
        params = table_params(Z)
        llr = noisy_llrs(params, max(ns), esn0_db, 100 + Z, device)
        for schedule, dtype in [(s, t) for s in schedules
                                for t in (message_dtypes if s == "layered" else ("float32",))]:
            kw = dict(DECODE_KW, iterations=iterations, message_dtype=dtype)
            fit = fitting_ps(params, schedule, ps if schedule == "layered" else
                             [P for P in ps if P in FLOODING_PS])
            autos = {n: decoder_cuda.auto_codewords_per_block(
                params, n, schedule, kw["algorithm"], dtype) for n in ns}
            occupancy = {P: decoder_cuda.blocks_per_sm(
                params, schedule, message_dtype=dtype, codewords_per_block=P)
                for P in {*fit, *autos.values()}}
            for n in ns:
                x = llr[:n]
                reps = max(3, min(30, 32768 // n))
                us = {}
                for P in sorted({*fit, autos[n]}):
                    fn = lambda: decoder_cuda.decode(
                        params, x, schedule=schedule, codewords_per_block=P, **kw)
                    us[P] = time_ms(fn, reps) * 1e3 / n
                res = decoder_cuda.decode(params, x, schedule=schedule, **kw)
                rows.append({
                    "bg": params.BG, "Z": Z, "A": params.A, "schedule": schedule,
                    "message_dtype": dtype, "n": n,
                    "iterations": iterations, "esn0_db": esn0_db,
                    "passed": float(res.parity_ok.float().mean()),
                    "us_per_codeword": us, "blocks_per_sm": occupancy,
                    "best_P": min(us, key=us.get),
                    "auto_P": autos[n],
                    "mean_iterations": float(res.iterations.float().mean()),
                })
    return rows


def held_times_us(fn, reps: int, hold_cycles: int = 100_000_000) -> tuple:
    """(device, host) microseconds per call of ``fn``: the stream is held by
    a sleeping kernel (``hold_cycles`` clock cycles) while the host queues
    ``reps`` calls, so the events
    time the calls back to back on the card and the host's clock times
    their queueing alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)  # about 50 ms at the H100's 1.98 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps, host_s * 1e6 / reps


def launch_split(device, zs=(5, 8, 13, 20, 26, 32), ns=(256, 2048, 4096),
                 message_dtypes=PACKING_DTYPES, trials: int = 3):
    """One record per (Z, message type, n, trial): for one codeword per
    block and the automatic choice, microseconds per call as
    ``packing_table`` times them (``time_ms``: the host and the card
    together), on the card alone and on the host alone (``held_times_us``).
    The layered min-sum decode of ``packing_table``'s rows."""
    rows = []
    for Z in zs:
        params = table_params(Z)
        llr = noisy_llrs(params, max(ns), ESN0_DB, 100 + Z, device)
        for dtype in message_dtypes:
            kw = dict(DECODE_KW, message_dtype=dtype)
            for n in ns:
                x = llr[:n]
                reps = max(3, min(30, 32768 // n))
                auto = decoder_cuda.auto_codewords_per_block(params, n, "layered",
                                                             kw["algorithm"], dtype)
                for trial in range(trials):
                    for P in sorted({1, auto}):
                        fn = lambda: decoder_cuda.decode(params, x, codewords_per_block=P, **kw)
                        call_us = time_ms(fn, reps) * 1e3
                        device_us, host_us = held_times_us(fn, reps)
                        rows.append({"bg": params.BG, "Z": Z, "message_dtype": dtype,
                                     "n": n, "P": P, "auto": P == auto, "trial": trial,
                                     "call_us": call_us, "device_us": device_us,
                                     "host_us": host_us})
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


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("small_z: no CUDA device; this tool measures a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_name_and_power_limit()
    if "split" in args:
        for row in launch_split(device):
            print(json.dumps({"table": "split", **row, "card": card}), flush=True)
        return 0
    for row in packing_table(device):
        print(json.dumps({"table": "packing", **row, "card": card}), flush=True)
    # a sweep's conditions: the reference's 50-iteration budget, below and
    # above the waterfall, where the codewords of a block stop far apart
    for esn0_db in (1.0, 3.0):
        for row in packing_table(device, zs=(2, 8, 20, 32, 48), ns=(4096, 16384),
                                 iterations=50, esn0_db=esn0_db):
            print(json.dumps({"table": "packing_budget_50", **row, "card": card}),
                  flush=True)
    if "packing" in args:
        return 0
    for row in routing_table(device):
        print(json.dumps({"table": "routing", **row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
