"""Lifting-size sweep (BASELINE config #3).

The counterpart of the repository's ``tools/lifting_sweep.py``: exercises
both base graphs across the standard lifting sizes with higher-order
modulations on a rate-matched K/N grid.  For each (BG, Z, modulation)
configuration it runs a high-SNR end-to-end round trip (must be error-free)
and one mid-SNR point (records the BLER) through the full chain, with backend
'auto': the flooding kernel on a GPU, its plain version on the CPU.

Writes --out (default ``results/torch/lifting_sweep.json``) and exits 1 if a
high-SNR round trip failed.  Use --quick to take every third Z.

Example:  python -m ldpc_3gpp_tpu_torch.tools.lifting_sweep --quick
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from ..spec.tables import ALL_LIFTING_SIZES

#: the port's own output; never under golden/ (the JAX package's goldens)
DEFAULT_OUT = os.path.join("results", "torch", "lifting_sweep.json")
HIGH_ESN0_DB = 30.0
ITERATIONS = 20
#: mid-SNR point near the waterfall of each (modulation, rate)
MID_ESN0_DB = {("16QAM", 1 / 2): 6.5, ("64QAM", 1 / 2): 11.0,
               ("16QAM", 1 / 3): 4.0, ("64QAM", 1 / 3): 8.0}


def params_for_z(bg, Z, qm, rate):
    """Single-code-block params selecting exactly lifting size Z, or None."""
    from ..spec.params import LDPCParams
    from ..spec.tables import UnsupportedParameters

    if bg == 1:
        kb = 22
    else:
        for kb in (10, 9, 8, 6):
            kp = kb * Z
            chk = 10 if kp > 640 else 9 if kp > 560 else 8 if kp > 192 else 6
            if chk == kb:
                break
    K_prime = kb * Z
    L = 16 if K_prime - 16 <= 3824 else 24
    A = K_prime - L
    if A <= 0:
        return None
    # Rate over K' (info+CRC), not A: at tiny Z the CRC dominates and a
    # rate over A alone yields G < K' — an undecodable configuration (the
    # 2Z punctured systematic bits could never be recovered).
    G = int(round(K_prime / rate / qm) * qm)
    try:
        p = LDPCParams(BG=bg, A=A, G=G, Q_m=qm)
    except UnsupportedParameters:
        return None
    if p.Z_c != Z or p.C != 1:
        return None
    return p


def sweep_configs(quick: bool = False):
    """(bg, Z, modulation, rate, params or None) of every configuration, in
    the sweep's order: both base graphs, 16QAM and 64QAM alternating over
    Z, rate 1/2 on BG1 and 1/3 on BG2."""
    zs = list(ALL_LIFTING_SIZES)
    if quick:
        zs = zs[::3]
    out = []
    for bg in (1, 2):
        for i, Z in enumerate(zs):
            mod, qm = (("16QAM", 4), ("64QAM", 6))[i % 2]
            rate = 1 / 2 if bg == 1 else 1 / 3
            out.append((bg, Z, mod, rate, params_for_z(bg, Z, qm, rate)))
    return out


def chain_config(params, modulation):
    from ..models.chain import ChainConfig

    return ChainConfig(params=params, modulation=modulation, iterations=ITERATIONS,
                       algorithm="min-sum", backend="auto")


def high_snr_errors(params, modulation, Z, batch, device):
    """(blocks, block errors) of ``batch`` blocks at 30 dB, the stream seeded
    ``Z``."""
    from ..models.chain import simulate_batch
    from ..utils.rng import make_generator

    r = simulate_batch(chain_config(params, modulation), make_generator(Z, device),
                       HIGH_ESN0_DB, batch, device=device)
    return int(r.blocks), int(r.block_errors)


def mid_snr_errors(params, modulation, rate, Z, batch, device):
    """(Es/N0, block errors) of ``batch`` blocks at the mid-SNR point, the
    stream seeded ``1000 + Z``."""
    from ..models.chain import simulate_batch
    from ..utils.rng import make_generator

    esn0 = MID_ESN0_DB[(modulation, rate)]
    r = simulate_batch(chain_config(params, modulation), make_generator(1000 + Z, device),
                       esn0, batch, device=device)
    return esn0, int(r.block_errors)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ldpc_3gpp_tpu_torch.tools.lifting_sweep")
    ap.add_argument("--quick", action="store_true", help="subsample every 3rd Z")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain versions)")
    args = ap.parse_args(argv)

    results = []
    t_start = time.time()
    for bg, Z, mod, rate, p in sweep_configs(args.quick):
        if p is None:
            results.append({"bg": bg, "Z": Z, "status": "unsupported"})
            continue
        hi_blocks, hi_errs = high_snr_errors(p, mod, Z, args.batch, args.device)
        hi_ok = hi_errs == 0 and hi_blocks == args.batch
        mid_esn0, mid_errs = mid_snr_errors(p, mod, rate, Z, args.batch, args.device)
        rec = {
            "bg": bg, "Z": Z, "i_LS": p.i_LS, "A": p.A, "G": p.G,
            "modulation": mod, "rate": round(rate, 4),
            "high_snr_block_errors": hi_errs,
            "blocks": args.batch,
            "mid_esn0_db": mid_esn0,
            "mid_bler": mid_errs / args.batch,
            "status": "ok" if hi_ok else "HIGH-SNR ERRORS",
        }
        results.append(rec)
        print(f"BG{bg} Z={Z:3d} {mod} A={p.A:5d}: high-SNR errors "
              f"{hi_errs}/{hi_blocks}, BLER@{mid_esn0}dB {rec['mid_bler']:.3f}")
    bad = [r for r in results if r.get("status") == "HIGH-SNR ERRORS"]
    summary = {
        "description": "Lifting-size sweep (BASELINE config #3): both base "
        "graphs across the standard lifting sizes, alternating 16QAM/64QAM, "
        "single-code-block rate-matched grid; high-SNR roundtrip must be "
        "error-free, mid-SNR BLER recorded (PyTorch/CUDA port).",
        "configs_run": len([r for r in results if r.get("status") != "unsupported"]),
        "high_snr_failures": len(bad),
        "elapsed_s": round(time.time() - t_start, 1),
        "results": results,
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\n{summary['configs_run']} configs, {len(bad)} high-SNR failures "
          f"-> {args.out}")
    if bad:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
