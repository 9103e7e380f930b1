"""Bulk Monte-Carlo at a fixed Es/N0 (BASELINE config #5, one node's scale).

The counterpart of the repository's ``tools/bulk_montecarlo.py``: simulates
a large number of transport blocks at one Es/N0 with counters summed over
every rank, and reports the BLER with a tight confidence interval and the
sustained throughput.  On several GPUs the same command fans out over all of
them (``torchrun --nproc-per-node=N -m ldpc_3gpp_tpu_torch.tools.bulk_montecarlo``
or ``parallel/launcher.py``): blocks/s scale with the ranks, since the ranks
exchange nothing but the counters, once per call.  Only rank 0 writes.

Example:  python -m ldpc_3gpp_tpu_torch.tools.bulk_montecarlo --blocks 1000000 --esn0 15.75
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

#: the port's own output; never under golden/ (the JAX package's goldens)
DEFAULT_OUT = os.path.join("results", "torch", "bulk_montecarlo.json")


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ldpc_3gpp_tpu_torch.tools.bulk_montecarlo")
    ap.add_argument("--blocks", type=int, default=10_000_000)
    ap.add_argument("--A", type=int, default=1000)
    ap.add_argument("--rate", type=float, default=1 / 2)
    ap.add_argument("--bg", type=int, default=1)
    ap.add_argument("--modulation", default="256QAM")
    ap.add_argument("--esn0", type=float, default=17.0)
    ap.add_argument("--iterations", type=int, default=12)
    # Deep calls: a bulk run has no adaptive host decisions to feed, so
    # unlike the sweeps there is no reason to keep calls small: 512 x 128 =
    # 65,536 blocks per call and rank, one host synchronisation (and one
    # all-reduce) per call.  The BLER statistics are untouched.  On an H100
    # (700 W limit) at the bulk golden's configuration (BG1 A=1000 256QAM,
    # 15.75 dB) calls of 512 x 76 blocks ran 1.8-2.0 times the sweeps' 256 x
    # 1 in two runs of chip_smoke.py (phase `campaign`: 50,921 against 28,480
    # and 29,741 against 14,766 TB/s; the host sets the level, the larger
    # batch and the one synchronisation per 76 steps are not measured apart).
    ap.add_argument("--batch-per-device", type=int, default=512)
    ap.add_argument("--steps-per-call", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--algorithm", default="min-sum",
                    choices=["min-sum", "offset-min-sum", "sum-product"])
    ap.add_argument("--schedule", default="layered", choices=["layered", "flooding"])
    # full parameter engine (NRLDPC.m:51-85 tunables)
    ap.add_argument("--N-L", type=int, default=1, dest="N_L")
    ap.add_argument("--I-LBRM", type=int, default=0, dest="I_LBRM")
    ap.add_argument("--TBS-LBRM", type=int, default=None, dest="TBS_LBRM")
    ap.add_argument("--CBGTI", type=int, nargs="*", default=(), dest="CBGTI")
    ap.add_argument("--rv-sequence", type=int, nargs="*", default=(0,),
                    dest="rv_sequence",
                    help="HARQ redundancy-version sequence (default: 0)")
    ap.add_argument("--cbgti-seq", default=None, dest="cbgti_seq",
                    help="per-stage CBGTI as JSON, e.g. '[[],[0]]' — stage i "
                         "excludes the listed code blocks (tunable-"
                         "between-steps CBGTI, NRLDPC.m:71-85)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the rank's GPU) or 'cpu' (plain versions)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..parallel.launcher import init_distributed

    # NCCL takes CUDA tensors only: a CPU run sums its counters under gloo
    owns_group = init_distributed(backend="gloo" if args.device == "cpu" else None)
    try:
        return _run(args)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args) -> dict:
    from ..models.chain import ChainConfig
    from ..ops.modulation import Q_M
    from ..parallel.launcher import is_primary
    from ..parallel.montecarlo import MonteCarlo
    from ..spec.params import LDPCParams
    from ..utils.fingerprint import semantics_fingerprint
    from ..utils.rng import make_generator

    qm = Q_M[args.modulation]
    unit = qm * args.N_L
    G = round(args.A / args.rate / unit) * unit
    params = LDPCParams(BG=args.bg, A=args.A, G=G, Q_m=qm, N_L=args.N_L,
                        I_LBRM=args.I_LBRM, TBS_LBRM=args.TBS_LBRM,
                        CBGTI=tuple(args.CBGTI))
    cbgti_seq = (None if args.cbgti_seq is None else
                 tuple(tuple(c) for c in json.loads(args.cbgti_seq)))
    cfg = ChainConfig(
        params=params, modulation=args.modulation, iterations=args.iterations,
        algorithm=args.algorithm, backend="auto", schedule=args.schedule,
        rv_sequence=tuple(args.rv_sequence), cbgti_sequence=cbgti_seq,
    )
    mc = MonteCarlo(cfg, batch_per_device=args.batch_per_device,
                    steps_per_call=args.steps_per_call, device=args.device)
    generator = make_generator(args.seed, args.device)
    primary = is_primary()
    totals = {"blocks": 0, "block_errors": 0, "bit_errors": 0, "iterations": 0}
    mc.run(generator, args.esn0)  # warm-up (kernel build and load), not counted
    t0 = time.time()
    last_print = t0
    # every rank leaves the loop on the same all-reduced count
    while totals["blocks"] < args.blocks:
        remaining = -(-(args.blocks - totals["blocks"]) // mc.blocks_per_run)
        c = mc.run_pipelined(generator, args.esn0, min(8, max(1, remaining)))
        for k in totals:
            totals[k] += c[k]
        now = time.time()
        if primary and now - last_print > 20:
            rate_bps = totals["blocks"] / (now - t0)
            print(f"{totals['blocks']:,} blocks, {totals['block_errors']:,} "
                  f"errors, {rate_bps:,.0f} blocks/s", flush=True)
            last_print = now
    dt = time.time() - t0
    bler = totals["block_errors"] / totals["blocks"]
    result = {
        "description": "Bulk Monte-Carlo (BASELINE config #5 at one node's "
        f"scale): fixed-SNR {args.modulation} link, counters summed over "
        "every rank (PyTorch/CUDA port).",
        # decoder-semantics stamp of the port's sources
        "semantics": semantics_fingerprint(),
        "config": {
            "BG": args.bg, "A": args.A, "G": G, "modulation": args.modulation,
            "esn0_db": args.esn0, "iterations": args.iterations,
            "algorithm": args.algorithm, "schedule": args.schedule,
            "N_L": args.N_L, "I_LBRM": args.I_LBRM,
            "TBS_LBRM": args.TBS_LBRM, "CBGTI": list(args.CBGTI),
            "rv_sequence": list(args.rv_sequence),
            "cbgti_sequence": (None if cbgti_seq is None
                               else [list(c) for c in cbgti_seq]),
            "N_cb": params.N_cb, "N": params.N,
            "devices": mc.world_size,
        },
        "blocks": totals["blocks"],
        "block_errors": totals["block_errors"],
        "bit_errors": totals["bit_errors"],
        "bler": bler,
        "mean_iterations_per_cb": totals["iterations"] / max(totals["blocks"] * params.C, 1),
        "elapsed_s": round(dt, 1),
        "transport_blocks_per_sec": round(totals["blocks"] / dt, 1),
        "info_mbps": round(totals["blocks"] / dt * args.A / 1e6, 2),
    }
    if primary:
        print(json.dumps(result, indent=1))
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
