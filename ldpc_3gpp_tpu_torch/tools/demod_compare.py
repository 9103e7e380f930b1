#!/usr/bin/env python3
"""Exact against max-log LLR demodulation: two BLER waterfalls on one 64QAM
link, measured on the card.

The port's counterpart of the repository's ``tools/demod_compare.py``.  The
reference's NRDemodulator exposes DecisionMethod = 'Log-likelihood ratio' |
'Approximate log-likelihood ratio' (NRDemodulator.m:10); this artifact shows
the same knob end to end: two waterfalls on an identical 64QAM BG1 link that
differ only in the demodulation method.  Expected: max-log within ~0.1 dB of
exact at these rates.

Usage: python -m ldpc_3gpp_tpu_torch.tools.demod_compare
           [--out results/torch/golden/demod_methods_64QAM.json] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

from ..utils.artifacts import DEFAULT_DIR, card_label, check_out_path, dump

# tools/demod_compare.py:36-42 (backend 'pallas' is the port's 'auto')
PROTOCOL = dict(
    A=4008, rate=1 / 2, bg=1, modulation="64QAM", iterations=12,
    target_block_errors=100, target_bler=1e-3, esn0_start=8.0, esn0_delta=0.25,
    seed=0, algorithm="min-sum", backend="auto", schedule="layered",
    batch_per_device=1024, steps_per_call=2,
)
METHODS = ("exact", "maxlog")


def run(out_path: str, device="cuda", results_dir=os.path.join("results", "torch"),
        **overrides) -> dict:
    """Both waterfalls at ``PROTOCOL`` (with ``overrides``) into
    ``out_path``; returns the artifact."""
    from ..parallel.sweep import bler_vs_snr
    from ..utils.fingerprint import semantics_fingerprint
    from .regen_goldens import _cut, _merge

    check_out_path(out_path)
    p = _merge(PROTOCOL, overrides)
    out = {
        "description": (
            "Exact vs max-log ('Approximate log-likelihood ratio', "
            f"NRDemodulator.m:10) soft demodulation on a {p['modulation']} "
            f"link: BG{p['bg']} A={p['A']} R={p['rate']:.4g}, layered "
            f"normalized min-sum {p['iterations']} iterations, "
            f">={p['target_block_errors']} block errors per point, seed "
            f"{p['seed']}, {p['batch_per_device']} x {p['steps_per_call']} "
            "blocks per call, the port's layered kernel (backend 'auto') on "
            f"{card_label(device)}." + _cut(overrides)
        ),
        "semantics": semantics_fingerprint(),
    }
    args = {k: v for k, v in p.items() if k not in ("A", "rate", "bg")}
    for method in METHODS:
        (pts,) = bler_vs_snr(A=[p["A"]], rate=[p["rate"]], bg=[p["bg"]], **args,
                             demod_method=method, results_dir=results_dir,
                             device=device).values()
        out[method] = {
            "esn0_db": [pt.esn0_db for pt in pts],
            "bler": [pt.bler for pt in pts],
            "blocks": [pt.blocks for pt in pts],
        }
    dump(os.path.dirname(out_path) or ".", os.path.basename(out_path), out)
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ldpc_3gpp_tpu_torch.tools.demod_compare",
                                 description="Exact vs max-log demodulation "
                                 "waterfalls on a 64QAM link.")
    ap.add_argument("--out", default=os.path.join(DEFAULT_DIR, "demod_methods_64QAM.json"))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    check_out_path(args.out)
    from ..utils.device import resolve_device

    return run(args.out, resolve_device(args.device))


if __name__ == "__main__":
    main()
