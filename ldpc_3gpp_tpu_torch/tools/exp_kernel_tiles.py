"""The decoder kernels' launch shape, scanned: the rules' choice against the
alternatives.

The counterpart of the JAX package's ``tools/exp_kernel_tiles.py``, which
scans the Pallas ``batch_tile`` (4, 8, 16, 32) of both schedules (rows
``<schedule> Bt=<tile>``, the ``jax_name`` of the flagship rows here).  The
port has no batch tile; what sets its launch is the codewords per block of
the layered kernels (``codewords_per_block``, chosen by
``decoder_cuda.auto_codewords_per_block``) and the block size of the
flooding kernels (``decode``'s internal ``_threads``, chosen by
``decoder_cuda.flooding_threads``), both read through ``launch_shape``.
Two cases, min-sum, early termination:

- ``flagship``: the JAX tool's rows, BG1 A=8424 G=25272 Z=384, 512
  codewords of synthetic ``'cw'`` LLRs ``2 N(0,1) + 1`` (a
  ``torch.Generator`` seeded 0), 12 iterations; layered P in (1, 2, 4, 8),
  flooding 512 and 1,024 threads.  Only P=1 fits at Z=384: the others print
  ``"fits": false`` with the ``ValueError`` of
  ``decoder_cuda.resolve_codewords_per_block``.
- ``config #1``: ``bler_vs_snr``'s launch at BG2 A=100 G=200 Z=20, 2,048
  codewords at 2.0 dB, 50 iterations, ``'d'`` in and ``'sys'`` out, the
  LLRs of ``tools/flooding_shapes.py``'s ``config #1`` case (seed 0);
  layered P in (1, 2, 4, 8, 16), flooding 64 to 1,024 threads.

Each row: ms, µs per codeword, mean sweeps, the launch shape, whether it is
the rules' choice, and whether its bits, parity flags and iteration counts
equal the rules' launch's (every alternative must).  Timing and equality are
``flooding_shapes.time_launches``'s: the mean of ``--reps`` launches after a
warm-up by CUDA events on the card (the host clock for ``--device cpu``,
where the plain versions run: not a device time).

    python3 -m ldpc_3gpp_tpu_torch.tools.exp_kernel_tiles [--reps 10]
        [--device cuda|cpu]

prints one JSON line per row with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import decoder_cuda
from ..spec.params import LDPCParams
from ..utils.rng import make_generator
from .exp_alpha import flagship_params, launch_of, printable, shape_label
from .flooding_shapes import CASES as FLOODING_CASES
from .flooding_shapes import case_llrs, time_launches

REPS = 10
MIN_SUM = dict(algorithm="min-sum")
_, CONFIG1_FIELDS, CONFIG1_ESN0_DB, CONFIG1_N, CONFIG1_KW, CONFIG1_THREADS = next(
    c for c in FLOODING_CASES if c[0] == "config #1")
# (case, codewords, decode keywords but the schedule, layered P, flooding threads)
CASES = (
    ("flagship", 512, dict(MIN_SUM, iterations=12), (1, 2, 4, 8), (512, 1024)),
    ("config #1", CONFIG1_N, {k: v for k, v in CONFIG1_KW.items() if k != "schedule"},
     (1, 2, 4, 8, 16), CONFIG1_THREADS),
)


def case_inputs(case: str, n: int, device):
    """(params, LLRs) of a case."""
    if case == "flagship":
        params = flagship_params()
        return params, 2.0 * torch.randn((n, params.num_cols * params.Z_c),
                                         generator=make_generator(0, device),
                                         device=device) + 1.0
    params = LDPCParams(**CONFIG1_FIELDS)
    return params, case_llrs(params, n, CONFIG1_ESN0_DB, 0, device)


def case_rows(case: str, params, llr, kw: dict, ps, threads, reps: int = REPS) -> list:
    """Both schedules' rows of a case: the rules' launch first, then every
    alternative that fits, then those that do not."""
    n = llr.shape[0]
    rows = []
    for schedule in decoder_cuda.SCHEDULES:
        rule = launch_of(params, n, schedule, {}, llr.device)
        if schedule == "layered":
            shapes = [dict(codewords_per_block=P)
                      for P in dict.fromkeys((rule["codewords_per_block"], *ps))]
        else:
            shapes = [dict(_threads=T) for T in dict.fromkeys((rule["threads"], *threads))]
        labels, misfits = {}, []
        for shape in shapes:
            row = dict(name=f"{case} {schedule} {shape_label(shape)}",
                       jax_name=f"{schedule} Bt" if case == "flagship" else None,
                       case=case, schedule=schedule, Z=params.Z_c, codewords=n)
            try:
                decoder_cuda.resolve_codewords_per_block(
                    params, n, schedule, shape.get("codewords_per_block", 0))
            except ValueError as e:
                misfits.append(dict(row, fits=False, error=str(e)))
                continue
            labels[row["name"]] = (row, shape)
        timed = time_launches(params, llr, dict(kw, schedule=schedule),
                              {name: shape for name, (_, shape) in labels.items()},
                              reps, llr.device)
        for name, (row, shape) in labels.items():
            t = timed[name]
            shown = launch_of(params, n, schedule, shape, llr.device)
            rows.append(dict(
                row, fits=True, ms=t["ms"], us_per_codeword=t["ms"] * 1e3 / n,
                mean_sweeps=float(t["result"].iterations.float().mean()), launch=shown,
                rule_choice=shown == rule, equal_to_the_rule=t["equal"],
                result=t["result"]))
        rows += misfits
    return rows


def main(argv=None) -> list:
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.exp_kernel_tiles", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=REPS, help="timed launches per row")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    rows = []
    for case, n, kw, ps, threads in CASES:
        params, llr = case_inputs(case, n, dev)
        for row in case_rows(case, params, llr, kw, ps, threads, args.reps):
            print(json.dumps(printable(row, card)), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
