"""The (batch, steps) scan behind ``bench.py``'s headline protocol.

The counterpart of the JAX package's ``tools/exp_bench_scan.py``: decoded
TB/s and Gbit/s of the flagship (BG1 A=8424 Z=384 R=1/3 QPSK, layered
normalized min-sum, 12 iterations, early termination, 1.0 dB) at each
``batch:steps`` pair, through ``bench.measure_throughput_detail`` (a warm-up
call, then trials of ``reps`` calls with one host fetch each, the best trial
taken; the median and the spread of the trials beside it).  The defaults are
the JAX tool's pairs plus 1024:2, the step of ``chip_smoke.py``'s main path
(P1).  A batch above 64 that is not a multiple of 128 is rounded up, as the
JAX package does; each line gives the batch simulated.

    python3 -m ldpc_3gpp_tpu_torch.tools.exp_bench_scan [batch:steps ...]
        [--trials 3] [--reps 6] [--device cuda|cpu]

prints one JSON line per pair with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

PAIRS = ((128, 1024), (256, 512), (384, 256), (512, 256), (1024, 2))


def main(argv=None) -> list:
    from ..bench import FLAGSHIP, HEADLINE_ESN0_DB, _flagship_config, measure_throughput_detail
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.exp_bench_scan", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pairs", nargs="*", help="batch:steps (default: the JAX pairs + 1024:2)")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    pairs = [tuple(int(v) for v in s.split(":")) for s in args.pairs] or list(PAIRS)
    cfg = _flagship_config()
    rows = []
    for batch, steps in pairs:
        d = measure_throughput_detail(cfg, HEADLINE_ESN0_DB, batch=batch, steps=steps,
                                      trials=args.trials, reps=args.reps, device=dev)
        tbs = d["tb_per_sec"]
        rec = {"pair": f"{batch}:{steps}", "batch_simulated": d["batch"], "steps": steps,
               "tb_per_sec": tbs, "gbit_per_s": tbs * FLAGSHIP["A"] / 1e9,
               "median_tb_per_sec": d["median_tb_per_sec"],
               "trials_tb_per_sec": d["trials_tb_per_sec"], "spread_max_over_min": d["spread"],
               "mean_iterations_per_tb": d["mean_iterations_per_tb"],
               "block_errors": d["block_errors"], "blocks": d["blocks"],
               "launches": d["launches"], "trials": args.trials, "reps": args.reps,
               "device": card}
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    return rows


if __name__ == "__main__":
    main()
