#!/usr/bin/env python3
"""Times of the main one-codeword kernels, for comparing two trees.

    python3 time_kernels.py

run from the root of a checkout builds that checkout's kernels and times, on
``chip_smoke.py``'s inputs, five means of several launches each by CUDA
events:

- V1: layered min-sum, BG1 A=8424 Z=384, 1,024 codewords at 1.0 dB, 12
  iterations; at the same shape V1' (offset-min-sum, 'cw' in and out,
  natural order), V4-layered (run to the budget) and V6-layered (bfloat16
  messages);
- V7-layered and V7-flooding: the packed kernels at config #1's launch,
  BG2 A=100 Z=20, 2,048 codewords at 2.0 dB, min-sum, 4 codewords per
  block, 12 and 50 iterations; V7-flooding-P1: the one-codeword flooding
  kernel at V7-flooding's launch;
- V2: layered sum-product, BG2 A=2048 Z=208, 1,024 codewords at 2.0 dB, 8
  iterations;
- V3-SP and V3-NMS: flooding sum-product and min-sum, BG2 A=3842 Z=208,
  2,048 codewords at 1.0 dB, 8 iterations;
- V3-SP-sweep and V3-SP-sweep-A1000: flooding sum-product as ``snr_vs_a``
  launches it, BG1 R=1/3, 256 codewords, 50 iterations, at A=8000 (Z=384,
  -1.6 dB) and A=1000 (Z=48, -1.0 dB);

then one ``snr_vs_a`` call at A=8000 (``MonteCarlo.run`` of 256 blocks at
-1.6 dB): host ms per call, and from ``torch.profiler`` the flooding kernel's
ms per call and the device's idle share.  Prints one JSON line with the
registers, stack and spills ``ptxas`` reported and the card's name and power
limit.  To compare
a change with its parent, unpack the parent into a directory the repository
ignores, copy this file beside its ``chip_smoke.py``, and run parent, change,
change, parent in one go on one card.  Needs a CUDA device.
"""
import json
import os
import subprocess
import sys
import time


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ldpc_3gpp_tpu_torch import kernels_build
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu_torch.parallel.sweep import _make_config
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True).stdout.strip()
    kernels_build.build()
    registers = [ln.strip() for n in kernels_build.kernel_names()
                 for ln in kernels_build.build_log(n).splitlines()
                 if "registers" in ln or "Compiling entry" in ln or "stack frame" in ln]
    ds = dict(channel_format="d", output_format="sys")
    flooding = dict(schedule="flooding", **ds)
    sweep_a8000 = dict(BG=1, A=8000, G=24000, Q_m=2)
    out = {"root": root, "card": card, "registers": registers}
    v1 = dict(iterations=12, algorithm="min-sum", **ds)
    for name, fields, esn0_db, n, reps, kw in (
        ("V1", cs.FLAGSHIP, 1.0, 1024, 50, v1),
        ("V1'", cs.FLAGSHIP, 1.0, 1024, 20, dict(
            iterations=12, algorithm="offset-min-sum", layer_order="natural")),
        ("V4-layered", cs.FLAGSHIP, 1.0, 1024, 10, dict(v1, early_termination=False)),
        ("V6-layered", cs.FLAGSHIP, 1.0, 1024, 20, dict(v1, message_dtype="bfloat16")),
        ("V7-layered", cs.CONFIG1_FIELDS, 2.0, cs.CONFIG1_BATCH, 50,
         dict(v1, codewords_per_block=cs.CONFIG1_PACK)),
        ("V7-flooding", cs.CONFIG1_FIELDS, 2.0, cs.CONFIG1_BATCH, 20,
         dict(iterations=50, algorithm="min-sum", codewords_per_block=cs.CONFIG1_PACK,
              **flooding)),
        ("V7-flooding-P1", cs.CONFIG1_FIELDS, 2.0, cs.CONFIG1_BATCH, 20,
         dict(iterations=50, algorithm="min-sum", codewords_per_block=1, **flooding)),
        ("V2", cs.P3_FIELDS, 2.0, 1024, 20, dict(iterations=8, algorithm="sum-product", **ds)),
        ("V3-SP", cs.P2_FIELDS, 1.0, 1024, 20,
         dict(iterations=8, algorithm="sum-product", **flooding)),
        ("V3-NMS", cs.P2_FIELDS, 1.0, 1024, 20,
         dict(iterations=8, algorithm="min-sum", **flooding)),
        ("V3-SP-sweep", sweep_a8000, -1.6, 256, 10,
         dict(iterations=50, algorithm="sum-product", **flooding)),
        ("V3-SP-sweep-A1000", dict(BG=1, A=1000, G=3000, Q_m=2), -1.0, 256, 10,
         dict(iterations=50, algorithm="sum-product", **flooding)),
    ):
        params = LDPCParams(**fields)
        d, _ = cs.noisy_d_tilde(params, "QPSK", esn0_db, n, 21, dev)
        if kw.get("channel_format") != "d":
            d = cs.codeword_llrs(params, d[:, 0])
        out[name] = [cs.time_ms(lambda: decoder_cuda.decode(params, d, **kw), reps=reps)
                     for _ in range(5)]
        del d

    # one snr_vs_a call at A=8000, as the sweep makes it
    cfg = _make_config(8000, 1 / 3, 1, "QPSK", (0,), 50, "sum-product")
    mc = MonteCarlo(cfg, batch_per_device=256, steps_per_call=1, device=dev)
    generator = make_generator(7, dev)
    call = lambda: mc.run(generator, -1.6)  # noqa: E731
    call()
    calls = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / calls * 1e3
    prof = cs.profile_steps(call, calls, call_ms)
    kernel_ms = (None if prof["top"] is None else
                 sum(r["ms_per_step"] for r in prof["top"] if "ldpc_flooding" in r["name"]))
    out["snr_vs_a_call_A8000"] = dict(host_ms_per_call=call_ms,
                                      flooding_kernel_ms_per_call=kernel_ms,
                                      device_idle_share=prof.get("device_idle_share"),
                                      device_busy_ms_per_call=prof["device_busy_ms_per_step"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
