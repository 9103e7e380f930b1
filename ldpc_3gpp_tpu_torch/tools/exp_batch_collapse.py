"""Full-chain throughput against the batch, with batches that are not
multiples of 128.

The counterpart of the JAX package's ``tools/exp_batch_collapse.py``, which
found the JAX chain's TB/s at batches 96, 160 and 192 at about half of batch
128's and looked for the cause upstream of its kernel.  The flagship (BG1
A=8424 Z=384 QPSK, layered normalized min-sum, 12 iterations, early
termination, 1.0 dB) throughout.

Phase ``full`` (default): the bench-style timing (``MonteCarlo`` calls of
``steps`` steps, four calls per host fetch, the median of ``reps``) of the
whole chain over the batch scan.  ``MonteCarlo`` rounds a batch above 64 that
is not a multiple of 128 up, as the JAX package does (96 stays, 160 and 192
become 256); each line gives the batch requested and the batch simulated,
and the time per transport block simulated.

Phase ``stages``: the same timing shape (``utils/profiling.loop_times``, the
three in turns) for
the kernel decode alone (``kernel``: fresh noisy codeword LLRs, 2 N(0,1) +
1, through the layered kernel), the transport-block decode alone
(``tbdec``: ``decode_transport_block`` of fresh noisy (batch, G) LLRs) and
the front of the chain alone (``front``: info bits, encode, modulate, AWGN,
exact demodulation), at the batches given exactly.

    python3 -m ldpc_3gpp_tpu_torch.tools.exp_batch_collapse [full|stages]
        [batch ...] [--steps 64] [--reps 6] [--device cuda|cpu]

prints one JSON line per (phase row, batch) with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

BATCHES = (64, 96, 128, 160, 192)
STEPS = 64
ESN0_DB = 1.0
CALLS = 4


def _full(cfg, batch, steps, reps, dev):
    from ..parallel.montecarlo import MonteCarlo
    from ..utils.rng import make_generator

    mc = MonteCarlo(cfg, batch_per_device=batch, steps_per_call=steps, device=dev)
    generator = make_generator(0, dev)
    mc.run(generator, ESN0_DB)  # warm-up, ends in a fetch
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        mc.run_pipelined(generator, ESN0_DB, calls=CALLS)  # one fetch
        times.append((time.perf_counter() - t0) / CALLS)
    return statistics.median(times) / (mc.batch_per_device * steps), mc.batch_per_device


def _stage_steps(cfg, batch, generator, dev):
    """{row: step} of the ``stages`` phase at ``batch``."""
    from ..models.decoder import decode_transport_block
    from ..models.encoder import encode_transport_block
    from ..ops import decoder_cuda
    from ..ops.channel import awgn, esn0_to_variance
    from ..ops.modulation import demodulate, modulate

    p = cfg.params
    nv = p.num_cols * p.Z_c
    var = esn0_to_variance(ESN0_DB, device=dev)
    dec = dict(iterations=cfg.iterations, algorithm=cfg.algorithm, schedule=cfg.schedule)

    def noisy(n):
        return 2.0 * torch.randn((batch, n), generator=generator, device=dev) + 1.0

    def kernel():
        return decoder_cuda.decode(p, noisy(nv), **dec).iterations

    def tbdec():
        return decode_transport_block(p, noisy(p.G), None, backend=cfg.backend,
                                      **dec).iterations

    def front():
        a = torch.randint(0, 2, (batch, p.A), generator=generator, device=dev,
                          dtype=torch.int8)
        tx = modulate(encode_transport_block(p, a), "QPSK")
        return demodulate(awgn(generator, tx, var), "QPSK", var, "exact")

    return {"kernel": kernel, "tbdec": tbdec, "front": front}


def main(argv=None) -> list:
    from ..bench import _flagship_config
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device
    from ..utils.profiling import loop_times
    from ..utils.rng import make_generator

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.exp_batch_collapse", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("phase", nargs="?", default="full", choices=("full", "stages"))
    ap.add_argument("batches", nargs="*", type=int)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    cfg = _flagship_config()
    rows = []
    for batch in args.batches or BATCHES:
        if args.phase == "full":
            t, simulated = _full(cfg, batch, args.steps, args.reps, dev)
            timed = {"full": (t, simulated)}
        else:
            generator = make_generator(0, dev)
            timed = {name: (t / (batch * args.steps), batch) for name, t in loop_times(
                _stage_steps(cfg, batch, generator, dev), args.steps, CALLS, args.reps,
                dev).items()}
        for name, (t, simulated) in timed.items():
            rec = {"name": name, "batch": batch, "batch_simulated": simulated,
                   "us_per_tb": t * 1e6, "tb_per_sec": 1 / t, "steps": args.steps,
                   "reps": args.reps, "device": card}
            print(json.dumps(rec), flush=True)
            rows.append(rec)
    return rows


if __name__ == "__main__":
    main()
