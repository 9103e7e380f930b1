#!/usr/bin/env python3
"""Rebuild ``<dir>/plots/*.png`` from the measured artifacts in ``<dir>``.

The port's counterpart of the repository's ``tools/regen_plots.py``: pure
matplotlib, no device, no simulation.  Run after
``python -m ldpc_3gpp_tpu_torch.tools.regen_goldens`` so the figures match
the numbers.  matplotlib is not needed by anything else of the port.

Usage: python -m ldpc_3gpp_tpu_torch.tools.regen_plots [--dir golden_torch]
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional

from ..utils.artifacts import DEFAULT_DIR, check_out_path


def _load(root, name):
    with open(os.path.join(root, name)) as f:
        return json.load(f)


def _card(root) -> str:
    """The device named in the headline artifact's description."""
    desc = _load(root, "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json")["description"]
    m = re.search(r"NVIDIA[^,;]*, [\d.]+ W", desc)
    return m.group(0) if m else "the host CPU"


def bler_curves(root, plots):
    from ..utils.plotting import _pyplot

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    head = _load(root, "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json")
    ax.semilogy(head["esn0_db"], head["bler"], marker="o",
                label="BG2 A=3842 R=1/3 SP-flooding 8it (reference default)")
    cmp_ = _load(root, "BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json")
    for key, style in (("NMS-flooding", "s"), ("NMS-layered-pallas", "^")):
        label = key.replace("-pallas", "")
        ax.semilogy(cmp_[key]["esn0_db"], cmp_[key]["bler"], marker=style,
                    label=f"BG2 A=3842 {label} 8it")
    c1 = _load(root, "BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json")
    ax.semilogy(c1["esn0_db"], c1["bler"], marker="d", label="BG2 A=100 R=1/2 NMS 50it")
    c2 = _load(root, "config2_and_harq.json")["BG1_A8448_layered_NMS_12it"]
    ax.semilogy(c2["esn0_db"], c2["bler"], marker="v",
                label="BG1 A=8448 R=1/3 layered-NMS 12it")
    ax.set_xlabel("$E_s/N_0$ [dB]")
    ax.set_ylabel("BLER")
    ax.set_title(f"3GPP NR LDPC, QPSK, AWGN — measured ({_card(root)})")
    ax.grid(True, which="both", alpha=0.4)
    ax.legend(loc="lower left", fontsize=8)
    out = os.path.join(plots, "bler_curves.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)


def snr_vs_a(root, plots):
    from ..utils.plotting import plot_snr_vs_a as _plot

    d = _load(root, "SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json")
    curve = list(zip(d["A"], d["required_esn0_db"]))
    out = _plot({1 / 3: curve}, os.path.join(plots, "snr_vs_a.png"),
                title="Required $E_s/N_0$ @ BLER$=10^{-2}$ vs A "
                      "(BG1, R=1/3, QPSK, SP 50it)")
    print("wrote", out)


def harq_ir(root, plots):
    from ..utils.plotting import _pyplot

    plt = _pyplot()
    d = _load(root, "config2_and_harq.json")
    fig, ax = plt.subplots(figsize=(7, 5))
    ss = d["harq_single_shot_rv0"]
    ax.semilogy(ss["esn0_db"], ss["bler"], marker="o", label="single transmission (rv 0)")
    ir = d["harq_harq_ir_rv0231"]
    ax.semilogy(ir["esn0_db"], ir["bler"], marker="*", markersize=14,
                linestyle="none", label="HARQ IR rv (0,2,3,1), LLR accumulation")
    ax.set_xlabel("$E_s/N_0$ [dB]")
    ax.set_ylabel("BLER")
    ax.set_title("HARQ incremental redundancy, BG1 A=2000 R=0.8 QPSK, "
                 "layered-NMS 12it")
    ax.grid(True, which="both", alpha=0.4)
    ax.legend(loc="lower left")
    out = os.path.join(plots, "harq_ir.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)


def base_graphs(root, plots):
    from ..utils.plotting import plot_base_graph

    for bg in (1, 2):
        out = plot_base_graph(bg, 0, os.path.join(plots, f"base_graph_{bg}.png"))
        print("wrote", out)


def main(argv: Optional[list] = None) -> str:
    ap = argparse.ArgumentParser(prog="python -m ldpc_3gpp_tpu_torch.tools.regen_plots",
                                 description="Figures of the measured artifacts "
                                 "of a directory, into its plots/.")
    ap.add_argument("--dir", default=DEFAULT_DIR, help="the artifact directory")
    args = ap.parse_args(argv)
    plots = check_out_path(os.path.join(args.dir, "plots"))
    os.makedirs(plots, exist_ok=True)
    for fig in (bler_curves, snr_vs_a, harq_ir, base_graphs):
        fig(args.dir, plots)
    return plots


if __name__ == "__main__":
    main()
