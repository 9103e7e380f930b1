"""Mean sweeps and time of layered normalized min-sum over its alpha.

The counterpart of the JAX package's ``tools/exp_alpha.py``.  Early
termination makes the mean number of sweeps, and with it the decode's time,
a function of the check-node normalization alpha.  This scans alpha at the
bench code (BG1 A=8424 G=25272 Z=384, QPSK, layered min-sum, 12 iterations,
early termination) on ``--batch`` codewords at ``--esn0`` dB and prints, per
alpha (the JAX rows ``alpha=0.7000`` ... ``alpha=1.0000``), the mean
iterations, the block errors, µs per codeword and k codewords/s.

The LLRs are the JAX tools' ``make_llr`` (``cw_llrs``, which the other
experiment tools import with ``decode_row``, ``printable`` and the launch
shape helpers): info bits from numpy's ``default_rng(0)``, the
whole ``num_cols*Z`` codeword encoded, QPSK-modulated, sent through AWGN and
demodulated ('exact'), decoded as ``'cw'`` and counted against the codeword.
The codewords equal the JAX tools'; the noise comes from a
``torch.Generator`` (Philox, ``utils/rng.py::make_generator`` with seed 7)
where the JAX tools draw from key 7.  The JAX tool reads Es/N0 from the
``ESN0`` environment variable; here it is ``--esn0``.

Times are ``utils/profiling.slope_time``'s (the slope between 2 and
18 chained decodes, ``CALLS``, best of ``--reps``): CUDA events on the card;
the host clock for ``--device cpu``, where the plain versions run (not a
device time).

    python3 -m ldpc_3gpp_tpu_torch.tools.exp_alpha [--batch 2048] [--esn0 1.0]
        [--reps 5] [--device cuda|cpu]

prints one JSON line per alpha with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import decoder_cuda
from ..utils.device import sm_count
from ..utils.profiling import slope_time

BATCH = 2048
ESN0_DB = 1.0
ITERATIONS = 12
NOISE_SEED = 7  # the JAX tools' PRNGKey(7)
ALPHAS = (0.70, 0.75, 0.8125, 0.875, 0.9375, 1.0)
REPS = 5
CALLS = 18
# the bench decode: layered normalized min-sum, early termination
DECODE_KW = dict(iterations=ITERATIONS, algorithm="min-sum", schedule="layered")


def flagship_params():
    from ..bench import _flagship_config

    return _flagship_config(ITERATIONS).params


def cw_llrs(params, n: int, esn0_db: float, seed: int, device):
    """(codewords (n, num_cols*Z) int8, their LLRs (n, num_cols*Z) float32):
    ``n`` blocks of numpy-seeded info bits (``default_rng(0)``, fillers 0)
    encoded whole, QPSK over AWGN at ``esn0_db`` (noise from
    ``make_generator(seed)``), demodulated 'exact'."""
    from ..ops.channel import awgn, esn0_to_variance
    from ..ops.encoder import encode
    from ..ops.modulation import demodulate, modulate
    from ..utils.rng import make_generator

    c = np.random.default_rng(0).integers(0, 2, size=(n, params.K)).astype(np.uint8)
    c[:, params.K_prime:] = 0
    cw = encode(params, torch.from_numpy(c).to(device))
    var = esn0_to_variance(esn0_db, device=device)
    rx = awgn(make_generator(seed, device), modulate(cw, "QPSK"), var)
    return cw.to(torch.int8), demodulate(rx, "QPSK", var, "exact")


def decode_row(params, llr, cw, reps: int = REPS, **kw) -> dict:
    """One decode of the ``'cw'`` LLRs ``llr`` with ``kw`` through
    ``decoder_cuda.decode``, counted against the codewords ``cw``, and its
    time by ``slope_time`` up to ``CALLS`` chained decodes.  The row keeps
    the ``DecodeResult`` under ``result`` (``printable`` drops it)."""
    res = decoder_cuda.decode(params, llr, **kw)
    n = llr.shape[0]
    t = slope_time(lambda x: decoder_cuda.decode(params, x, **kw).bits, llr, k_hi=CALLS,
                   reps=reps)
    return dict(
        mean_iterations=float(res.iterations.float().mean()),
        block_errors=int((res.bits != cw).any(dim=-1).sum()),
        parity_failures=int((~res.parity_ok).sum()), codewords=n,
        us_per_codeword=t / n * 1e6, k_codewords_per_s=n / t / 1e3 if t > 0 else None,
        timed_by="CUDA events" if llr.is_cuda else
                 "host clock (plain versions on the CPU: not a device time)",
        result=res)


def printable(row: dict, card: str) -> dict:
    """``row`` without its decode result, with the device it ran on."""
    return {**{k: v for k, v in row.items() if k != "result"}, "device": card}


def shape_label(shape: dict) -> str:
    """``P=<P>`` or ``threads=<T>`` of a row's launch ``shape`` (its
    ``codewords_per_block`` or ``decode``'s internal ``_threads``)."""
    return (f"threads={shape['_threads']}" if "_threads" in shape
            else f"P={shape['codewords_per_block']}")


def launch_of(params, n: int, schedule: str, shape: dict, device) -> dict:
    """``decoder_cuda.launch_shape`` of ``n`` codewords on ``device``'s card
    (an H100's for a CPU device) at a row's launch ``shape``; ``{}`` is the
    rules' launch."""
    got = decoder_cuda.launch_shape(params, n, schedule, shape.get("codewords_per_block", 0),
                                    sm_count(device))
    if "_threads" in shape:
        got["threads"] = shape["_threads"]
    return got


def alpha_rows(params, llr, cw, alphas=ALPHAS, reps: int = REPS) -> list:
    """One row per alpha: the bench decode of ``llr`` at that alpha."""
    return [dict(name=f"alpha={alpha:6.4f}", alpha=alpha,
                 **decode_row(params, llr, cw, reps, alpha=alpha, **DECODE_KW))
            for alpha in alphas]


def main(argv=None) -> list:
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.exp_alpha", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=BATCH, help="codewords")
    ap.add_argument("--esn0", type=float, default=ESN0_DB, help="Es/N0 in dB")
    ap.add_argument("--reps", type=int, default=REPS, help="timed runs per slope end")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    params = flagship_params()
    cw, llr = cw_llrs(params, args.batch, args.esn0, NOISE_SEED, dev)
    rows = alpha_rows(params, llr, cw, reps=args.reps)
    for row in rows:
        print(json.dumps(printable(dict(row, esn0_db=args.esn0), card)), flush=True)
    return rows


if __name__ == "__main__":
    main()
