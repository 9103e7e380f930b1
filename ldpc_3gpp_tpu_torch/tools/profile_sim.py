"""Slope profile of the whole ``simulate_batch`` step and its pieces.

The counterpart of the JAX package's ``tools/profile_sim.py``, which
complements ``profile_stages.py`` (the chain's stages alone): the whole step
at the flagship (BG1 A=8424 Z=384 QPSK, layered normalized min-sum, 12
iterations, early termination) at 1.0 and at 6.0 dB, the info-bit draw and
the noise draw as the step makes them (from one ``torch.Generator``; the
JAX tool draws from keys), and the kernel decode with early termination at
both points.  Each row is timed by ``utils/profiling.slope_time`` (CUDA
events; per-call time as the slope between 2 and 18 chained calls) and,
beside it, ``torch.profiler``'s device-busy ms per call, the idle share
(1 - busy / time) and the device kernels per call (``profile_steps``).

    python3 -m ldpc_3gpp_tpu_torch.tools.profile_sim [--device cuda|cpu]
        [--batch 512]

prints one JSON line per row with the JAX tool's row name, the card's name
and power limit.  With ``--device cpu`` the rows are host-clock times of the
plain versions and nothing is profiled.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..utils.profiling import slope_time

BATCH = 512
ESN0_DB = (1.0, 6.0)
FLAGSHIP = dict(BG=1, A=8424, G=25272, Q_m=2)


def profile_steps(step, n, step_ms):
    """Device time per step by kernel name, from ``torch.profiler`` over
    ``n`` steps, and its share of the unprofiled step time ``step_ms``.
    Device numbers are None where the profiler shows no device time (then
    they are not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side operator rows repeat their kernels' time
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, ev.count / n, ev.key))
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        return {"steps": n, "device_busy_ms_per_step": None,
                "device_busy_share": None, "top": None}
    rows.sort(reverse=True)
    return {
        "steps": n, "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / step_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "kernels_per_step": sum(r[1] for r in rows),
        "top": [{"name": k[:60], "ms_per_step": ms, "per_step": c}
                for ms, c, k in rows[:6]],
    }


def measure(name, f, x, batch, dev, card, jax_name=None, profile_calls=3) -> dict:
    """One row: ``f(x)``'s per-call time by ``slope_time`` and, on the card,
    its profile; printed as one JSON line and returned."""
    seconds = slope_time(f, x)
    ms = seconds * 1e3
    rec = {"name": name, "ms_per_call": ms, "us_per_tb": seconds / batch * 1e6,
           "batch": batch}
    if jax_name is not None:
        rec["jax_name"] = jax_name
    if dev.type == "cuda":
        prof = profile_steps(lambda: f(x), profile_calls, ms)
        rec.update(device_busy_ms=prof["device_busy_ms_per_step"],
                   device_idle_share=prof.get("device_idle_share"),
                   kernels_per_call=prof.get("kernels_per_step"), top=prof["top"])
    else:
        rec.update(device_busy_ms="not measured (CPU)", timed_by="host clock")
    rec["device"] = card
    print(json.dumps(rec), flush=True)
    return rec


def flagship_config():
    from ..models.chain import ChainConfig
    from ..spec.params import LDPCParams

    return ChainConfig(params=LDPCParams(**FLAGSHIP), modulation="QPSK", rv_sequence=(0,),
                       iterations=12, algorithm="min-sum", early_termination=True,
                       backend="auto", schedule="layered")


def main(argv=None) -> list:
    from ..models.chain import simulate_batch
    from ..ops import decoder_cuda
    from ..ops.channel import complex_noise, esn0_to_variance
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device
    from ..utils.rng import make_generator
    from .roofline import noisy_d_tilde

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.profile_sim", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    batch = args.batch
    cfg = flagship_config()
    p = cfg.params
    generator = make_generator(0, dev)
    x = torch.zeros(1, device=dev)
    rows = []

    for esn0 in ESN0_DB:
        rows.append(measure(
            f"simulate_batch esn0={esn0:g}",
            lambda _, esn0=esn0: simulate_batch(cfg, generator, esn0, batch,
                                                device=dev).block_errors,
            x, batch, dev, card))
    var = esn0_to_variance(ESN0_DB[0], device=dev)
    rows.append(measure(
        "randint int8 info bits",
        lambda _: torch.randint(0, 2, (batch, p.A), generator=generator, device=dev,
                                dtype=torch.int8),
        x, batch, dev, card, jax_name="bernoulli info bits"))
    rows.append(measure(
        "complex normal noise",
        lambda _: complex_noise(generator, (batch, p.G // 2), var, dev).real,
        x, batch, dev, card, jax_name="normal noise"))
    kw = dict(iterations=12, algorithm="min-sum", schedule="layered",
              channel_format="d", output_format="sys")
    for esn0 in ESN0_DB:
        d, _ = noisy_d_tilde(p, "QPSK", esn0, batch, 0, dev)
        rows.append(measure(
            f"decode ET esn0={esn0:g}",
            lambda llr: decoder_cuda.decode(p, llr, **kw).bits,
            d, batch, dev, card))
    return rows


if __name__ == "__main__":
    main()
