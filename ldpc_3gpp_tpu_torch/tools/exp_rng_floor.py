"""What the step's random draws cost, in the ablation harness.

The counterpart of the JAX package's ``tools/exp_rng_floor.py``.  The port
draws every bit and every noise sample from one ``torch.Generator`` (Philox;
``utils/rng.py::make_generator``), where the JAX package splits and folds
keys, so each row is named by what it draws (the JAX row it stands for is in
``jax_name``).  Same harness as ``exp_fused_share.py`` (``steps`` steps
summed on the device, one host fetch per four calls, the median of five,
the rows in turns), at
the flagship's sizes (A=8424, G=25272, batch 128):

  floor                no draw (the harness's own cost)
  generator-state      the generator's state read and written back
                       (``get_state``/``set_state``), no draw
  info-bits-int8       the (batch, A) info bits as ``simulate_batch`` draws
                       them (``torch.randint`` to int8)
  raw-bits-uint8       the same bits from a raw byte draw, masked to one bit
  info-bits-3-sizes    three draws of (batch, A), (batch, A/2), (batch, A/4)
  noise-complex        the channel's noise as ``simulate_batch`` draws it
                       (``complex_noise``: two normal draws of (batch, G/2))

    python3 -m ldpc_3gpp_tpu_torch.tools.exp_rng_floor [--batch 128]
        [--steps 256] [--device cuda|cpu]

prints one JSON line per row with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

import torch

A, G = 8424, 25272
BATCH = 128
STEPS = 256
ESN0_DB = 1.0


def draws(batch, generator, dev):
    """[(name, jax_name, step)] of the rows."""
    from ..ops.channel import complex_noise, esn0_to_variance

    var = esn0_to_variance(ESN0_DB, device=dev)
    one = torch.ones((), device=dev)

    def info_bits(n):
        return torch.randint(0, 2, (batch, n), generator=generator, device=dev,
                             dtype=torch.int8)

    def generator_state():
        generator.set_state(generator.get_state())
        return one

    return [
        ("floor", "floor", lambda: one),
        ("generator-state", "key-ops", generator_state),
        ("info-bits-int8", "bern-1call", lambda: info_bits(A)),
        ("raw-bits-uint8", "bern-bits",
         lambda: torch.randint(0, 256, (batch, A), generator=generator, device=dev,
                               dtype=torch.uint8) & 1),
        ("info-bits-3-sizes", "bern-3calls",
         lambda: torch.stack([info_bits(n).sum(dtype=torch.int32)
                              for n in (A, A // 2, A // 4)])),
        ("noise-complex", "noise-only",
         lambda: complex_noise(generator, (batch, G // 2), var, dev).real),
    ]


def main(argv=None) -> list:
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device
    from ..utils.profiling import loop_times
    from ..utils.rng import make_generator

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.exp_rng_floor", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    generator = make_generator(0, dev)
    rows = []
    table = draws(args.batch, generator, dev)
    seconds = loop_times({name: step for name, _, step in table}, args.steps, calls=4, reps=5,
                         device=dev)
    for name, jax_name, _ in table:
        t = seconds[name] / (args.batch * args.steps)
        rec = {"name": name, "jax_name": jax_name, "us_per_tb": t * 1e6,
               "us_per_step": t * args.batch * 1e6, "batch": args.batch,
               "steps": args.steps, "device": card}
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    return rows


if __name__ == "__main__":
    main()
