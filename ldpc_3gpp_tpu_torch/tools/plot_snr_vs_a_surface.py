#!/usr/bin/env python3
"""Plot a measured SNR-vs-A surface (BASELINE config #4).

The port's counterpart of the repository's
``tools/plot_snr_vs_a_surface.py``.  Reads ``SNR_vs_A_surface.json``
(written by ``regen_goldens surface``) and renders one panel per BLER
target: required Es/N0 vs A, one curve per rate, sum-product solid and
normalized min-sum dashed, so the min-sum penalty is visible per point.

Usage: python -m ldpc_3gpp_tpu_torch.tools.plot_snr_vs_a_surface
           [--golden results/torch/golden/SNR_vs_A_surface.json]
           [--out results/torch/golden/plots/snr_vs_a_surface.png]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from ..utils.artifacts import DEFAULT_DIR, check_out_path

RATES = [("0.2", "R=1/5"), ("0.333333", "R=1/3"),
         ("0.5", "R=1/2"), ("0.666667", "R=2/3")]


def main(argv: Optional[list] = None) -> str:
    from ..utils.plotting import _pyplot

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.plot_snr_vs_a_surface",
        description="Required Es/N0 vs A of a measured surface, per target.")
    ap.add_argument("--golden", default=os.path.join(DEFAULT_DIR, "SNR_vs_A_surface.json"))
    ap.add_argument("--out", default=os.path.join(DEFAULT_DIR, "plots",
                                                  "snr_vs_a_surface.png"))
    args = ap.parse_args(argv)
    check_out_path(args.out)
    plt = _pyplot()

    with open(args.golden) as f:
        g = json.load(f)
    A = g["A"]

    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5), sharey=True)
    for ax, target in zip(axes, ("0.1", "0.01")):
        for i, (rk, label) in enumerate(RATES):
            color = f"C{i}"
            for algo, style in (("sum-product", "-"), ("min-sum", "--")):
                curve = g["curves"].get(f"{algo}/{rk}")
                if curve is None:
                    continue
                ax.plot(A, curve[f"required_esn0_db_at_{target}"], style, color=color,
                        label=f"{label} {algo}" if target == "0.1" else None)
        ax.set_title(f"required Es/N0 at BLER = {target}")
        ax.set_xlabel("A (transport block bits)")
        ax.grid(True, alpha=0.3)
    axes[0].set_ylabel("Es/N0 (dB)")
    axes[0].legend(fontsize=7, ncol=2)
    fig.suptitle("BG1 QPSK, flooding BP 50 it — SP solid, NMS dashed")
    fig.tight_layout()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.savefig(args.out, dpi=130)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
