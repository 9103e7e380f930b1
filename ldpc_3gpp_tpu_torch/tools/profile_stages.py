"""Slope profile of the chain's stages, each alone.

The counterpart of the JAX package's ``tools/profile_stages.py``: at its
batch of 256 transport blocks of BG1 A=8424 (Z=384, QPSK, 1.0 dB), each
stage's per-call time by ``utils/profiling.slope_time`` (CUDA events; the
slope between 2 and 18 chained calls, so fixed costs cancel):

- ``crc_attach`` (CRC24A), ``encode_rolls`` and ``encode_mxu`` (the
  transport-block encoder through both backends), ``modulate``,
  ``awgn+demod`` (the channel's noise and the exact LLR demodulation),
  ``split_rate_matched`` (the inverse of rate matching);
- ``decode_cuda_12``: the layered min-sum kernel at 12 iterations on the
  full codeword LLRs (the JAX tool's ``decode_pallas_12``);
- ``decode_fast_12``: the plain flooding min-sum decoder of backend 'fast'
  at 12 iterations on the same LLRs (the JAX tool's XLA decoder), timed at a
  shallower slope (it takes the card hundreds of small launches).

    python3 -m ldpc_3gpp_tpu_torch.tools.profile_stages [--device cuda|cpu]
        [--batch 256]

prints one JSON line per stage (ms per call, µs per codeword) with the card's
name and power limit.  With ``--device cpu`` the times are the host's.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..utils.profiling import slope_time

BATCH = 256
ESN0_DB = 1.0
FIELDS = dict(BG=1, A=8424, G=25272, Q_m=2)
# (k_lo, k_hi, reps) of the slope for the plain decoder: seconds per call
SLOW_SLOPE = (1, 3, 2)


def main(argv=None) -> list:
    from ..models.decoder import split_rate_matched
    from ..models.encoder import encode_transport_block
    from ..ops import decoder_cuda, decoder_fast
    from ..ops.channel import awgn, esn0_to_variance
    from ..ops.crc import crc_attach
    from ..ops.modulation import demodulate, modulate
    from ..spec.params import LDPCParams
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device
    from ..utils.rng import make_generator

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.profile_stages", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    batch = args.batch
    p = LDPCParams(**FIELDS)
    generator = make_generator(0, dev)
    a = torch.randint(0, 2, (batch, p.A), generator=generator, device=dev, dtype=torch.int8)
    var = esn0_to_variance(ESN0_DB, device=dev)
    g = encode_transport_block(p, a)
    tx = modulate(g, "QPSK")
    llr = demodulate(awgn(generator, tx, var), "QPSK", var, "exact")
    d = split_rate_matched(p, llr)
    cw = torch.cat([torch.zeros(batch, 1, 2 * p.Z_c, device=dev), d], dim=-1)
    dec = dict(iterations=12, algorithm="min-sum")

    stages = [
        ("crc_attach", lambda x: crc_attach(x, "CRC24A"), a, None, None),
        ("encode_rolls", lambda x: encode_transport_block(p, x, backend="rolls"), a, None,
         None),
        ("encode_mxu", lambda x: encode_transport_block(p, x, backend="mxu"), a, None, None),
        ("modulate", lambda x: modulate(x, "QPSK"), g, None, None),
        ("awgn+demod", lambda x: demodulate(awgn(generator, x, var), "QPSK", var, "exact"),
         tx, None, None),
        ("split_rate_matched", lambda x: split_rate_matched(p, x), llr, None, None),
        ("decode_cuda_12",
         lambda x: decoder_cuda.decode(p, x, schedule="layered", **dec).bits, cw,
         "decode_pallas_12", None),
        ("decode_fast_12", lambda x: decoder_fast.decode(p, x, **dec).bits, cw, None,
         SLOW_SLOPE),
    ]
    rows = []
    for name, f, x, jax_name, slope in stages:
        k_lo, k_hi, reps = slope or (2, 18, 5)
        t = slope_time(f, x, k_lo=k_lo, k_hi=k_hi, reps=reps)
        rec = {"name": name, "ms_per_call": t * 1e3, "us_per_codeword": t / batch * 1e6,
               "batch": batch, "slope_calls": [k_lo, k_hi], "reps": reps}
        if jax_name:
            rec["jax_name"] = jax_name
        rec.update(device=card,
                   timed_by="CUDA events" if dev.type == "cuda" else "host clock")
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    return rows


if __name__ == "__main__":
    main()
