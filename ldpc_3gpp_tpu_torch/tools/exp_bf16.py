"""float32 against bfloat16 check messages (``message_dtype``) on real
traffic, over the launch shapes.

The counterpart of the JAX package's ``tools/exp_bf16.py``.  At the bench
code (BG1 A=8424 G=25272 Z=384, QPSK, min-sum, 12 iterations, early
termination), on ``--batch`` whole-codeword LLRs at ``--esn0`` dB
(``exp_alpha.cw_llrs``), both schedules in both message types: µs per
codeword (``slope_time``: CUDA events on the card, the host clock on the
CPU), block errors and parity failures.  On the card the rows run V1's
kernel in ``'cw'`` form and V6-layered, and at Z=384 the flooding kernel in
a cluster of 3 blocks (V3-NMS-cluster, and its bfloat16 form).

The JAX tool scans the Pallas ``batch_tile`` (rows ``<schedule> <dtype>
Bt=<tile>``, the ``jax_name`` here without the tile); the port has none and
scans what sets its launch instead: layered ``codewords_per_block`` in (1,
2, 4) (rows ``layered <dtype> P=<P>``), flooding the block size through
``decode``'s internal ``_threads`` in (512, 1024) (rows ``flooding <dtype>
threads=<T>``).  A shape that does not fit a block prints ``"fits": false``
with the ``ValueError`` of ``decoder_cuda.resolve_codewords_per_block``
(the JAX tool prints ``FAILED``); at Z=384 only P=1 fits.  Nothing else is
caught: a launch or build failure raises.

    python3 -m ldpc_3gpp_tpu_torch.tools.exp_bf16 [--batch 512] [--esn0 1.0]
        [--reps 5] [--device cuda|cpu]

prints one JSON line per row with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

from ..ops import decoder_cuda
from .exp_alpha import (
    ESN0_DB, ITERATIONS, NOISE_SEED, REPS, cw_llrs, decode_row, flagship_params, launch_of,
    printable, shape_label,
)

BATCH = 512
DTYPES = ("float32", "bfloat16")
LAYERED_P = (1, 2, 4)
FLOODING_THREADS = (512, 1024)


def bf16_rows(params, llr, cw, reps: int = REPS) -> list:
    """One row per schedule, message type and launch shape."""
    n = llr.shape[0]
    rows = []
    for schedule, shapes in (
            ("layered", [dict(codewords_per_block=P) for P in LAYERED_P]),
            ("flooding", [dict(_threads=T) for T in FLOODING_THREADS])):
        for dtype in DTYPES:
            for shape in shapes:
                row = dict(name=f"{schedule} {dtype} {shape_label(shape)}",
                           jax_name=f"{schedule} {dtype}", schedule=schedule,
                           message_dtype=dtype)
                try:
                    decoder_cuda.resolve_codewords_per_block(
                        params, n, schedule, shape.get("codewords_per_block", 0))
                except ValueError as e:
                    rows.append(dict(row, fits=False, error=str(e)))
                    continue
                measured = decode_row(params, llr, cw, reps, iterations=ITERATIONS,
                                      algorithm="min-sum", schedule=schedule,
                                      message_dtype=dtype, **shape)
                rows.append(dict(row, fits=True,
                                 launch=launch_of(params, n, schedule, shape, llr.device),
                                 **measured))
    return rows


def main(argv=None) -> list:
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.exp_bf16", description=__doc__,
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
    rows = bf16_rows(params, llr, cw, args.reps)
    for row in rows:
        print(json.dumps(printable(dict(row, esn0_db=args.esn0), card)), flush=True)
    return rows


if __name__ == "__main__":
    main()
