#!/usr/bin/env python3
"""Times of the two main one-codeword kernels, for comparing two trees.

    python3 time_kernels.py

run from the root of a checkout builds that checkout's kernels and times V1
(layered min-sum, BG1 A=8424 Z=384, 1,024 codewords at 1.0 dB, 12 iterations)
and V3-SP (flooding sum-product, BG2 A=3842 Z=208, 2,048 codewords at 1.0 dB,
8 iterations) on ``chip_smoke.py``'s inputs: five means of 50 launches each,
by CUDA events, one JSON line with the registers ``ptxas`` reported.  To
compare a change with its parent, unpack the parent into a directory the
repository ignores, copy this file beside its ``chip_smoke.py``, and run
parent, change, change, parent in one go on one card.  Needs a CUDA device.
"""
import json
import os
import sys


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
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    dev = torch.device("cuda", 0)
    kernels_build.build()
    registers = [ln.strip() for n in kernels_build.kernel_names()
                 for ln in kernels_build.build_log(n).splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
    ds = dict(channel_format="d", output_format="sys")
    out = {"root": root, "registers": registers}
    for name, fields, n, kw in (
        ("V1", cs.FLAGSHIP, 1024, dict(iterations=12, algorithm="min-sum", **ds)),
        ("V3-SP", cs.P2_FIELDS, 1024, dict(iterations=8, algorithm="sum-product",
                                          schedule="flooding", **ds)),
    ):
        params = LDPCParams(**fields)
        d, _ = cs.noisy_d_tilde(params, "QPSK", 1.0, n, 21, dev)
        out[name] = [cs.time_ms(lambda: decoder_cuda.decode(params, d, **kw), reps=50)
                     for _ in range(5)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
