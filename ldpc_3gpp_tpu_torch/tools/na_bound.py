#!/usr/bin/env python3
"""Normal-approximation (PPV) bound anchor for the measured BLER surface.

The port's counterpart of the repository's ``tools/na_bound.py`` (numpy
only, so its values equal that tool's exactly).  The measured curves are
self-measured; this anchors them to a quantity anyone can recompute from the
literature, the normal approximation of Polyanskiy, Poor & Verdu ("Channel
coding rate in the finite blocklength regime", IEEE Trans. IT 56(5), 2010):

    log2 M*(n, eps) ~= n*C - sqrt(n*V) * Qinv(eps) + 0.5*log2(n)

for the binary-input AWGN channel.  Gray-mapped QPSK is two independent BPSK
subchannels, each a real BI-AWGN use at per-use SNR Es/N0, so a (A, G,
QPSK) configuration is n = G BI-AWGN uses carrying A information bits.  For
each surface point this computes the Es/N0 at which the normal approximation
permits A bits at the target BLER; the measured decoder must sit a small,
smoothly varying gap above it.

C and V of BI-AWGN (x = +-1, noise N(0, sigma^2), sigma^2 = 1/gamma):
    i(y)   = 1 - log2(1 + exp(-2*y/sigma^2)),   y ~ N(1, sigma^2)
    C      = E[i(y)],   V = Var[i(y)]   (bits, bits^2)
by trapezoidal quadrature.

Usage: python -m ldpc_3gpp_tpu_torch.tools.na_bound
           [--surface results/torch/golden/SNR_vs_A_surface.json]
           [--out results/torch/golden/na_bound.json]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
from typing import Optional

import numpy as np

from ..utils.artifacts import DEFAULT_DIR, check_out_path

DESCRIPTION = (
    "Normal-approximation (PPV 2010) required Es/N0 for each "
    "SNR_vs_A_surface.json point: BI-AWGN x2 (QPSK), n = G uses, "
    "k = A bits, targets 1e-1 and 1e-2.  Pure function of "
    "(A, G, target) — externally recomputable; gap_db_* = measured "
    "minus bound per algorithm/rate/A."
)


def biawgn_c_v(gamma: float, nodes: int = 20001, span: float = 14.0):
    """Capacity (bits/use) and dispersion (bits^2/use) of BI-AWGN at
    linear per-use SNR ``gamma`` (x = +-1, sigma^2 = 1/gamma).

    Trapezoidal quadrature of the information density over y ~ N(1, sigma^2)
    (numpy's hermgauss overflows past ~150 nodes, so no Gauss-Hermite).
    """
    sigma = 1.0 / math.sqrt(gamma)
    t = np.linspace(-span, span, nodes)
    y = 1.0 + sigma * t
    pdf = np.exp(-0.5 * t * t) / math.sqrt(2.0 * math.pi)
    # i(y) = 1 - log2(1 + exp(-2y/sigma^2)), computed stably
    z = -2.0 * y / (sigma * sigma)
    log1p_exp = np.where(z > 30, z, np.log1p(np.exp(np.minimum(z, 30.0))))
    i = 1.0 - log1p_exp / math.log(2.0)
    dt = t[1] - t[0]
    C = float(np.trapezoid(pdf * i, dx=dt))
    V = float(np.trapezoid(pdf * (i - C) ** 2, dx=dt))
    return C, V


def qinv(eps: float) -> float:
    """Inverse Gaussian Q-function by bisection on erfc."""
    lo, hi = -10.0, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if 0.5 * math.erfc(mid / math.sqrt(2.0)) > eps:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def na_required_esn0_db(A: int, G: int, eps: float) -> float:
    """Es/N0 (dB) at which the normal approximation permits A info bits in
    n = G BI-AWGN uses (QPSK) at block error rate eps."""
    n = G
    q = qinv(eps)

    def max_bits(esn0_db):
        gamma = 10.0 ** (esn0_db / 10.0)
        C, V = biawgn_c_v(gamma)
        return n * C - math.sqrt(n * V) * q + 0.5 * math.log2(n)

    lo, hi = -15.0, 25.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if max_bits(mid) < A:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ldpc_3gpp_tpu_torch.tools.na_bound",
                                 description="PPV normal-approximation bound of "
                                 "every point of a measured SNR-vs-A surface.")
    ap.add_argument("--surface", default=os.path.join(DEFAULT_DIR, "SNR_vs_A_surface.json"))
    ap.add_argument("--out", default=os.path.join(DEFAULT_DIR, "na_bound.json"))
    args = ap.parse_args(argv)
    check_out_path(args.out)
    with open(args.surface) as f:
        surface = json.load(f)
    rates = {"0.2": 1 / 5, "0.333333": 1 / 3, "0.5": 1 / 2, "0.666667": 2 / 3}
    description = DESCRIPTION
    card = re.search(r"NVIDIA[^,;]*, [\d.]+ W", surface.get("description", ""))
    if card:
        description += f"  The surface was measured on {card.group(0)}."
    out = {"description": description}
    if "semantics" in surface:  # a function of the surface: it carries its stamp
        out["semantics"] = surface["semantics"]
    out.update({"A": surface["A"], "bound_esn0_db": {}, "gap_db": {}})
    for r_key, rate in rates.items():
        for t_key, eps in (("0.1", 1e-1), ("0.01", 1e-2)):
            bounds = []
            for A in surface["A"]:
                G = int(round(A / rate / 2) * 2)
                bounds.append(round(na_required_esn0_db(A, G, eps), 4))
            out["bound_esn0_db"][f"{r_key}/{t_key}"] = bounds
            for algo in ("sum-product", "min-sum"):
                curve = surface["curves"].get(f"{algo}/{r_key}")
                if not curve:
                    continue
                meas = curve[f"required_esn0_db_at_{float(t_key):g}"]
                out["gap_db"][f"{algo}/{r_key}/{t_key}"] = [
                    None if m is None else round(m - b, 4)
                    for m, b in zip(meas, bounds)
                ]
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:  # the JAX tool's bytes: no final newline
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    for k, v in out["gap_db"].items():
        vals = [x for x in v if x is not None]
        print(f"{k:26s} gap dB: min {min(vals):+.2f} max {max(vals):+.2f}")
    return out


if __name__ == "__main__":
    main()
