"""Plot helpers mirroring the reference's live figures.

The reference updates MATLAB figures while sweeping (plot_BLER_vs_SNR.m:157-160,
plot_SNR_vs_A.m:177-184).  Headless GPU hosts render to PNG instead: call these
on sweep results (or on the results/*.txt files they wrote).  matplotlib is
imported inside each function, with the Agg backend, so importing this module
needs none.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    try:
        import matplotlib
    except ModuleNotFoundError as e:
        raise RuntimeError(
            "plots need matplotlib, which is not installed here; install it, "
            "or run without plots (--no-plot, live_plot=False)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_bler_curves(
    curves: Dict[tuple, list],
    out_path: str = "results/BLER_vs_SNR.png",
    title: str = "3GPP New Radio LDPC code, AWGN",
) -> str:
    """curves: {(bg, rate, A): [SweepPoint, ...]} from sweep.bler_vs_snr."""
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(7, 5))
    for (bg, rate, A), pts in sorted(curves.items()):
        xs = [p.esn0_db for p in pts if p.blocks > 0 and p.bler > 0]
        ys = [p.bler for p in pts if p.blocks > 0 and p.bler > 0]
        ax.semilogy(xs, ys, marker="o", label=f"BG{bg} R={rate:.3g} A={A}")
    ax.set_xlabel("$E_s/N_0$ [dB]")
    ax.set_ylabel("BLER")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.4)
    ax.legend(loc="lower left")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_snr_vs_a(
    curves: Dict[float, List[Tuple[int, float]]],
    out_path: str = "results/SNR_vs_A.png",
    title: str = "Required $E_s/N_0$ vs A",
) -> str:
    """curves: {rate: [(A, required_esn0), ...]} from sweep.snr_vs_a."""
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(7, 5))
    for rate, pts in sorted(curves.items()):
        xs = [a for a, _ in pts]
        ys = [s for _, s in pts]
        ax.plot(xs, ys, marker="s", label=f"R={rate:.3g}")
    ax.set_xlabel("A")
    ax.set_ylabel("Required $E_s/N_0$ [dB]")
    ax.set_title(title)
    ax.grid(True, alpha=0.4)
    ax.legend(loc="best")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_base_graph(bg: int, i_ls: int = 0, out_path: str = "results/base_graph.png") -> str:
    """Spy plot of a base graph (the reference's plot_base_graph.m)."""
    plt = _pyplot()
    import numpy as np

    from ..spec.tables import BG_DIMS, base_graph

    rows, cols, _ = base_graph(bg, i_ls)
    nr, nc, _ = BG_DIMS[bg]
    m = np.zeros((nr, nc))
    m[rows, cols] = 1
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.spy(m, markersize=4)
    ax.set_title(f"TS38.212 base graph {bg} (i_LS={i_ls})")
    ax.set_xlabel("variable node block")
    ax.set_ylabel("check node block")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_results_files(
    files: List[str],
    out_path: str = "results/overlay.png",
    title: str = "3GPP New Radio LDPC code, AWGN",
    vlines: List[str] = (),
) -> str:
    """Overlay reference-format results files on one figure.

    Accepts any mix of ``BLER_vs_SNR_*.txt`` (EsN0<TAB>BLER lines,
    semilog-y) or ``SNR_vs_A_*.txt`` (A<TAB>EsN0 lines, linear) — the
    layout this framework shares with the MATLAB reference
    (plot_BLER_vs_SNR.m:79-83,165 / plot_SNR_vs_A.m:79-83,186), so curves
    measured by either implementation (or by several seeded instances, the
    reference's manual-aggregation workflow) can be compared on one plot.
    ``#``-prefixed annotation lines (e.g. capped-point markers) are
    skipped.  The file kind is inferred from the basename; mixing kinds on
    one figure is rejected.

    ``vlines``: reference abscissas drawn as dashed vertical lines, each
    ``"<x>:<label>"`` (or just ``"<x>"``) — e.g. a density-evolution
    threshold from golden/de_thresholds.json next to its measured
    waterfall (``--vline=-1.977:'DE threshold'``), or on an SNR-vs-A
    figure a horizontal asymptote is more natural, so for that kind the
    value is drawn as a dashed HORIZONTAL line instead (required-Es/N0
    curves approach the threshold from above).
    """
    plt = _pyplot()

    kinds = set()
    parsed = []
    for f in files:
        base = os.path.basename(f)
        if base.startswith("BLER_vs_SNR"):
            kind = "bler"
        elif base.startswith("SNR_vs_A"):
            kind = "snr_vs_a"
        else:
            raise ValueError(
                f"{f}: cannot infer file kind (expect a BLER_vs_SNR_* or "
                "SNR_vs_A_* basename)"
            )
        kinds.add(kind)
        xs, ys = [], []
        with open(f) as fid:
            for line in fid:
                if line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) != 2:
                    continue
                xs.append(float(parts[0]))
                ys.append(float(parts[1]))
        parsed.append((base, xs, ys))
    if len(kinds) != 1:
        raise ValueError(f"mixed file kinds on one figure: {sorted(kinds)}")
    kind = kinds.pop()

    fig, ax = plt.subplots(figsize=(7, 5))
    for base, xs, ys in parsed:
        label = base[: -len(".txt")] if base.endswith(".txt") else base
        if kind == "bler":
            ax.semilogy(xs, ys, marker="o", label=label)
        else:
            ax.plot(xs, ys, marker="o", label=label)
    if kind == "bler":
        ax.set_xlabel("$E_s/N_0$ [dB]")
        ax.set_ylabel("BLER")
    else:
        ax.set_xlabel("A (information bits)")
        ax.set_ylabel("required $E_s/N_0$ [dB]")
    for spec in vlines:
        val, _, lab = str(spec).partition(":")
        x = float(val)
        if kind == "bler":
            ax.axvline(x, linestyle="--", color="k", alpha=0.6,
                       label=lab or f"x={x:g}")
        else:
            ax.axhline(x, linestyle="--", color="k", alpha=0.6,
                       label=lab or f"y={x:g}")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.4)
    ax.legend(loc="best", fontsize=7)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
