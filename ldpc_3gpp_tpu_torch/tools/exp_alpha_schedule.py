"""Iteration-dependent NMS normalization (``alpha_schedule``): sweeps, time
and BLER.

The counterpart of the JAX package's ``tools/exp_alpha_schedule.py``.  A
smaller alpha on the first n0 sweeps (alpha0), then the standard 0.8125, is
a known trick to damp the optimistic early messages of normalized min-sum.
At the bench code (BG1 A=8424 G=25272 Z=384, QPSK, layered min-sum, 12
iterations, early termination) this screens the baseline
(``alpha_schedule=None``, row ``baseline``) and the 15 candidates alpha0 in
(0.55, 0.6, 0.65, 0.7, 0.75) x n0 in (1, 2, 3) (rows ``sched=(alpha0,
n0)``) at +1.0 dB on ``--batch`` whole-codeword LLRs (``exp_alpha.cw_llrs``):
mean iterations, block errors, µs per codeword (``slope_time``: CUDA events
on the card, the host clock on the CPU).

Then the gate (rows ``GATE ...``): the three fastest candidates that beat
the baseline, and the baseline itself, at the two mid-waterfall points of
``golden/bench_path_bler.json`` QPSK_R13 (539 of 2,048 blocks at -0.75 dB,
159 of 264,192 at -0.5 dB): ``min(max(int(60 / bler), batch), 2**18)``
blocks per point, and z = (BLER - golden) / sigma with the JAX tool's
combined binomial sigma (``gate_sigma``).

Where the port differs on purpose: its gate's blocks are transport blocks of
``models/chain.py::simulate_batch`` at the bench configuration with the
candidate's ``alpha_schedule`` (rate matching to G = 25,272 bits, the first
2Z systematic bits punctured), the path that measured the golden.  The JAX
tool gates on whole-codeword LLRs, which send the punctured columns too:
about 0.14 dB more energy per block than the golden's channel
(10 log10(26,112 / 25,272)), which moves every z, the baseline's included.
The baseline's gate row shows the gate holding where it must.  Every
candidate's gate draws the same blocks and noise (one generator per point,
seeded 11 and 13 as the JAX tool's keys).

    python3 -m ldpc_3gpp_tpu_torch.tools.exp_alpha_schedule [--batch 2048]
        [--reps 5] [--device cuda|cpu]

prints one JSON line per screened row and per gated row with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

from .exp_alpha import (
    BATCH, DECODE_KW, ITERATIONS, NOISE_SEED, REPS, cw_llrs, decode_row, printable,
)

SCREEN_ESN0_DB = 1.0
CANDIDATES = tuple((a0, n0) for n0 in (1, 2, 3) for a0 in (0.55, 0.6, 0.65, 0.7, 0.75))
GATED = 3  # the fastest candidates that beat the baseline
# golden/bench_path_bler.json QPSK_R13: (Es/N0 dB, block errors, blocks, seed)
GATE_POINTS = ((-0.75, 539, 2048, 11), (-0.5, 159, 264192, 13))
MAX_GATE_BLOCKS = 1 << 18


def screen(params, llr, cw, candidates=CANDIDATES, reps: int = REPS) -> list:
    """The baseline's row, then one per candidate ``(alpha0, n0)``."""
    return [dict(name="baseline" if sched is None else f"sched={sched}",
                 alpha_schedule=sched,
                 **decode_row(params, llr, cw, reps, alpha_schedule=sched, **DECODE_KW))
            for sched in (None, *candidates)]


def to_gate(rows: list, n: int = GATED) -> list:
    """The baseline (``rows[0]``) and the ``n`` fastest rows that beat it."""
    base = rows[0]
    faster = sorted((r for r in rows[1:] if r["us_per_codeword"] < base["us_per_codeword"]),
                    key=lambda r: r["us_per_codeword"])
    return [base, *faster[:n]]


def gate_sigma(golden_bler: float, blocks: int, golden_blocks: int) -> float:
    """The JAX tool's combined binomial sigma of this sample and the
    golden's, both at the golden rate."""
    v = golden_bler * (1 - golden_bler)
    return math.sqrt(v / blocks + v / golden_blocks)


def gate_point(cfg, esn0_db: float, golden_errors: int, golden_blocks: int, seed: int,
               batch: int, device, max_blocks: int = MAX_GATE_BLOCKS) -> dict:
    """Transport blocks of ``cfg`` through ``simulate_batch`` at ``esn0_db``
    in steps of ``batch``, until ``min(max(int(60 / golden BLER), batch),
    max_blocks)``, against the golden point."""
    from ..models.chain import simulate_batch
    from ..utils.rng import make_generator

    golden_bler = golden_errors / golden_blocks
    need = min(max(int(60 / max(golden_bler, 1e-9)), batch), max_blocks)
    generator = make_generator(seed, device)
    blocks = errors = 0
    while blocks < need:
        errors += int(simulate_batch(cfg, generator, esn0_db, batch, device=device).block_errors)
        blocks += batch
    bler = errors / blocks
    sigma = gate_sigma(golden_bler, blocks, golden_blocks)
    return dict(esn0_db=esn0_db, blocks=blocks, block_errors=errors, bler=bler,
                golden_block_errors=golden_errors, golden_blocks=golden_blocks,
                golden_bler=golden_bler, sigma=sigma, z=(bler - golden_bler) / sigma)


def gate_row(cfg, row: dict, batch: int, device, points=GATE_POINTS,
             max_blocks: int = MAX_GATE_BLOCKS) -> dict:
    """The gate of one screened row: ``cfg`` with the row's schedule at
    each golden point."""
    cfg = dataclasses.replace(cfg, alpha_schedule=row["alpha_schedule"])
    return dict(name=f"GATE {row['name']}", alpha_schedule=row["alpha_schedule"],
                us_per_codeword=row["us_per_codeword"],
                points=[gate_point(cfg, esn0_db, errors, blocks, seed, batch, device,
                                   max_blocks)
                        for esn0_db, errors, blocks, seed in points])


def main(argv=None) -> dict:
    from ..bench import _flagship_config
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.exp_alpha_schedule", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="codewords screened, blocks per gate step")
    ap.add_argument("--reps", type=int, default=REPS, help="timed runs per slope end")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    cfg = _flagship_config(ITERATIONS)
    cw, llr = cw_llrs(cfg.params, args.batch, SCREEN_ESN0_DB, NOISE_SEED, dev)
    rows = screen(cfg.params, llr, cw, CANDIDATES, args.reps)
    for row in rows:
        print(json.dumps(printable(dict(row, esn0_db=SCREEN_ESN0_DB), card)), flush=True)
    gates = []
    for row in to_gate(rows):
        gates.append(gate_row(cfg, row, args.batch, dev, GATE_POINTS, MAX_GATE_BLOCKS))
        print(json.dumps(dict(gates[-1], device=card)), flush=True)
    return dict(screen=rows, gates=gates)


if __name__ == "__main__":
    main()
