"""The decoder's share of the simulation step, by ablation.

The counterpart of the JAX package's ``tools/exp_fused_share.py``.  The
same programs, each run as the benchmark runs the step (``steps`` steps
summed on the device, one host fetch per four calls, the median of five,
the programs in turns; ``utils/profiling.loop_times``), at the flagship (BG1 A=8424 Z=384 QPSK,
layered normalized min-sum, early termination, 1.0 dB):

  full-12it      the bench step (``simulate_batch``, 12 iterations)
  nodec          the same chain with the BP decode replaced by the channel's
                 hard decision: the fused demodulation into the circular
                 buffer, the 2Z punctured zeros, the filler pinning and the
                 CRC gates of the TB decode (``models/decoder.py``) kept
  dec-1it        the bench step with the decode at one iteration
  floor          an empty step (the harness's own cost)
  a-only, a+enc+mod, front, front+split, front-nonoise
                 the front of the chain in growing pieces

The decoder's share of the step is (full - nodec) / (full - floor).  Beside
the three programs, ``torch.profiler``'s device time by kernel per step.

    python3 -m ldpc_3gpp_tpu_torch.tools.exp_fused_share [batch]
        [--steps 256] [--device cuda|cpu]

prints one JSON line per program and one with the share, with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json

import torch

BATCH = 128
STEPS = 256
ESN0_DB = 1.0
PROFILED = ("full-12it", "nodec", "dec-1it")


def hard_decision_errors(p, d):
    """Blocks of the (batch, C, N) circular-buffer LLRs ``d`` that fail the
    TB decode's gates (``models/decoder.py``) on the channel's hard decision
    in place of the BP decode: the 2Z punctured zeros in front, the fillers
    pinned to ``FILLER_LLR``, each code block's CRC where C > 1, the
    transport block's CRC."""
    from ..models.decoder import FILLER_LLR
    from ..ops.crc import crc_check

    batch = d.shape[0]
    cw = torch.cat([torch.zeros(d.shape[:-1] + (2 * p.Z_c,), device=d.device), d], dim=-1)
    if p.K_prime < p.K:
        cw[..., p.K_prime:p.K] = FILLER_LLR
    c_hat = (cw < 0).to(torch.int8)
    tb_ok = ~crc_check(c_hat[..., :p.K_prime - p.cb_crc_len].reshape(batch, p.B), p.tb_crc)
    if p.C > 1:
        tb_ok &= (~crc_check(c_hat[..., :p.K_prime], p.cb_crc)).all(dim=-1)
    return (~tb_ok).sum()


def programs(batch, generator, dev):
    """[(name, step)] of the ablation at ``batch``."""
    from ..bench import _flagship_config
    from ..models.chain import simulate_batch
    from ..models.decoder import split_rate_matched_symbols
    from ..models.encoder import encode_to_symbols
    from ..ops.channel import complex_noise, esn0_to_variance

    cfg12, cfg1 = _flagship_config(12), _flagship_config(1)
    p = cfg12.params
    var = esn0_to_variance(ESN0_DB, device=dev)

    def bits():
        return torch.randint(0, 2, (batch, p.A), generator=generator, device=dev,
                             dtype=torch.int8)

    def received():
        tx = encode_to_symbols(p, bits(), "QPSK")
        return tx + complex_noise(generator, tx.shape, var, dev)

    def full(cfg):
        return lambda: simulate_batch(cfg, generator, ESN0_DB, batch, device=dev).block_errors

    def nodec():
        return hard_decision_errors(
            p, split_rate_matched_symbols(p, received(), "QPSK", var, "exact"))

    def front_nonoise():
        return (encode_to_symbols(p, bits(), "QPSK") + (0.1 + 0.1j)).real

    return [
        ("floor", lambda: torch.ones((), device=dev)),
        ("a-only", bits),
        ("a+enc+mod", lambda: encode_to_symbols(p, bits(), "QPSK").real),
        ("full-12it", full(cfg12)),
        ("nodec", nodec),
        ("dec-1it", full(cfg1)),
        ("front", lambda: received().real),
        ("front+split",
         lambda: split_rate_matched_symbols(p, received(), "QPSK", var, "exact")),
        ("front-nonoise", front_nonoise),
    ]


def main(argv=None) -> dict:
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device
    from ..utils.profiling import loop_times
    from ..utils.rng import make_generator
    from .profile_sim import profile_steps

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.exp_fused_share", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    batch, steps = args.batch, args.steps
    generator = make_generator(0, dev)
    progs = dict(programs(batch, generator, dev))
    results = {name: t / (batch * steps)
               for name, t in loop_times(progs, steps, calls=4, reps=5, device=dev).items()}
    for name, step in progs.items():
        t = results[name]
        rec = {"name": name, "us_per_tb": t * 1e6, "tb_per_sec": 1 / t,
               "ms_per_step": t * batch * 1e3, "batch": batch, "steps": steps,
               "device": card}
        if name in PROFILED and dev.type == "cuda":
            prof = profile_steps(step, 3, t * batch * 1e3)
            rec.update(device_busy_ms_per_step=prof["device_busy_ms_per_step"],
                       device_idle_share=prof.get("device_idle_share"),
                       kernels_per_step=prof.get("kernels_per_step"),
                       device_ms_by_kernel=prof["top"])
        print(json.dumps(rec), flush=True)
    floor = results["floor"]
    share = {
        "decode_share_of_step": (results["full-12it"] - results["nodec"])
        / (results["full-12it"] - floor),
        "non_decode_us_per_tb": (results["nodec"] - floor) * 1e6,
        "harness_floor_us_per_tb": floor * 1e6, "batch": batch, "device": card,
    }
    print(json.dumps(share), flush=True)
    return {"programs": results, **share}


if __name__ == "__main__":
    main()
