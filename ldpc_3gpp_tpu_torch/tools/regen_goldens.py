#!/usr/bin/env python3
"""Measure the port's golden BLER artifacts on the card.

The port's counterpart of the repository's ``tools/regen_goldens.py``.  The
curves are measured properties of the code, so after a change of decoder
semantics they are re-measured, never edited by hand.  Each stage writes one
artifact with the JAX golden's file name and keys, at the protocol of the
JAX stage it ports (each protocol below cites the JAX lines), plus the port's
``semantics`` fingerprint; every description names the card and its power
limit.  Output goes to ``--out-dir`` (default ``results/torch/golden/``,
git-ignored); a path under ``golden/``, the JAX package's stamped artifacts,
is refused.  The artifacts measured on an H100 are committed under
``golden_torch/``.

Stages (all by default, or name a subset):
  headline  BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json + txt
  spvsms    BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json
  config1   BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json
  config2   config2_and_harq.json (BG1 A=8448 waterfall + HARQ IR demo)
  benchcfg  bench_path_bler.json (the bench configuration + 64QAM)
  surface   SNR_vs_A_surface.json (A x rate x {1e-1,1e-2} x {SP,MS}; resumes)
  snrvsa    SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json + txt
  bulk      bulk_montecarlo.json (20M 256QAM blocks @ 15.75 dB)
  bulksp    bulk_sp_montecarlo.json (2M QPSK blocks, SP flooding)
  bulklbrm  bulk_lbrm_montecarlo.json (2M blocks, N_L=2 + LBRM-limited)
  bulkcbgti bulk_cbgti_montecarlo.json (2M blocks, per-stage CBGTI HARQ)
  bench_sweep bench_sweep.json (the port's ``bench.py --sweep`` rows)

Like the JAX tool, it refuses to run while ``doc_consistency`` finds a doc
of the port quoting another headline protocol than ``bench.py``'s.
``--restamp`` refreshes the ``semantics`` stamp of every artifact in the
directory without re-measuring: only after a change shown neutral on the
card (``chip_smoke.py``'s ``goldens`` phase re-measures points of these
artifacts and prints whether their stamps are current).

Each stage function takes keyword overrides of its protocol, so that a test
can run it small; a description records any such cut.  Each stage prints one
JSON line with its wall seconds, blocks and decode launches.

Usage: python -m ldpc_3gpp_tpu_torch.tools.regen_goldens [stage ...]
           [--out-dir DIR] [--device cuda|cpu] [--force-resume] [--restamp]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from typing import Optional

from ..utils.artifacts import DEFAULT_DIR, card_label, check_out_path, dump
from ..utils.fingerprint import semantics_fingerprint

#: where the sweeps' reference-format results files go (the JAX stages but
#: headline and snrvsa write theirs to "results"); git-ignored
RESULTS_DIR = os.path.join("results", "torch")

# tools/regen_goldens.py:64-71 (backend 'pallas' is the port's 'auto': the
# CUDA kernels, bit-exact to the plain decoders)
HEADLINE = dict(
    A=3842, rate=1 / 3, bg=2, modulation="QPSK", iterations=8,
    target_block_errors=100, target_bler=1e-3, esn0_start=0.0, esn0_delta=0.25,
    seed=0, algorithm="sum-product", backend="auto", schedule="flooding",
    batch_per_device=512, steps_per_call=2,
)
# tools/regen_goldens.py:91-96, the three curves of :111-120
SPVSMS = dict(
    A=3842, rate=1 / 3, bg=2, modulation="QPSK", iterations=8,
    target_block_errors=100, target_bler=1e-3, esn0_start=0.0, esn0_delta=0.25,
    seed=0, batch_per_device=512, steps_per_call=2, backend="auto",
    curves=(("SP-flooding", "sum-product", "flooding"),
            ("NMS-flooding", "min-sum", "flooding"),
            ("NMS-layered-pallas", "min-sum", "layered")),
)
# tools/regen_goldens.py:127-133, with one deliberate difference: the JAX
# stage runs its XLA decoder (backend "fast"); the port runs its flooding
# kernel (backend 'auto'), bit-exact to its plain 'fast' decoder, whose
# draws do not depend on the backend: the same points, in seconds instead of
# a quarter of an hour of the plain decoder's launches on the card
CONFIG1 = dict(
    A=100, rate=1 / 2, bg=2, modulation="QPSK", iterations=50,
    target_block_errors=100, target_bler=1e-3, esn0_start=0.0, esn0_delta=0.5,
    seed=0, algorithm="min-sum", backend="auto", schedule="flooding",
    batch_per_device=1024, steps_per_call=2,
)
# tools/regen_goldens.py:163-169 (waterfall) and :181-190 (HARQ IR demo:
# each curve a fresh stream of seed 0, every point with found_start set and
# at most 2,000,000 blocks)
CONFIG2 = dict(
    waterfall=dict(
        A=8448, rate=1 / 3, bg=1, modulation="QPSK", iterations=12,
        target_block_errors=100, target_bler=1e-3, esn0_start=-0.5,
        esn0_delta=0.25, seed=0, algorithm="min-sum", backend="auto",
        schedule="layered", batch_per_device=2048, steps_per_call=1,
    ),
    harq=dict(
        A=2000, rate=0.8, bg=1, modulation="QPSK", iterations=12,
        algorithm="min-sum", backend="auto", schedule="layered",
        batch_per_device=1024, steps_per_call=2, seed=0, max_blocks=2_000_000,
        curves=(("harq_single_shot_rv0", (0,), tuple(x * 0.5 for x in range(12)), 100),
                ("harq_harq_ir_rv0231", (0, 2, 3, 1), (0.0,), 20)),
    ),
)
# tools/regen_goldens.py:210-222
BENCHCFG = dict(
    common=dict(
        iterations=12, target_block_errors=150, target_bler=1e-3, seed=0,
        algorithm="min-sum", backend="auto", schedule="layered",
        batch_per_device=1024, steps_per_call=2,
    ),
    QPSK_R13=dict(A=8424, rate=1 / 3, bg=1, modulation="QPSK", esn0_start=-1.25,
                  esn0_delta=0.25),
    QAM64_R12=dict(A=8424, rate=1 / 2, bg=1, modulation="64QAM", esn0_start=10.0,
                   esn0_delta=0.25),
)
# tools/regen_goldens.py:240-351: (rate key, rate, start Es/N0) at :292-294
# and :297-298, 1,024 x 2 blocks per call at :313, 100 errors, at most
# 2,000,000 blocks per point and 0.1 dB steps at :319-323
SURFACE = dict(
    A=tuple(range(1000, 8001, 1000)), bg=1, modulation="QPSK", iterations=50,
    algorithms=("sum-product", "min-sum"), backend="auto", schedule="flooding",
    rates=(("0.2", 1 / 5, -6.0), ("0.333333", 1 / 3, -3.5), ("0.5", 1 / 2, -1.5),
           ("0.666667", 2 / 3, 0.5)),
    targets=(1e-1, 1e-2), target_block_errors=100, esn0_delta=0.1, seed=0,
    batch_per_device=1024, steps_per_call=2, max_blocks=2_000_000,
)
# tools/regen_goldens.py:357-358 with snr_vs_a's defaults
# (ldpc_3gpp_tpu/parallel/sweep.py snr_vs_a, plot_SNR_vs_A.m:37-49); the
# JAX stage's XLA backend is the port's 'auto' here: V3-SP, bit-exact to it
SNRVSA = dict(
    A=tuple(range(1000, 8001, 1000)), rate=1 / 3, bg=1, modulation="QPSK",
    iterations=50, target_block_errors=100, target_bler=1e-2, esn0_start=-2.0,
    esn0_delta=0.1, seed=0, algorithm="sum-product", backend="auto",
    schedule="flooding", batch_per_device=512, steps_per_call=2,
)
# tools/regen_goldens.py:379-383 (--blocks, --esn0) over the JAX bulk tool's
# defaults (tools/bulk_montecarlo.py:24-55), and :397-404, :419-427, :446-455
BULK = dict(
    blocks=20_000_000, A=1000, rate=1 / 2, bg=1, modulation="256QAM", esn0=15.75,
    iterations=12, algorithm="min-sum", schedule="layered",
    batch_per_device=512, steps_per_call=128,
)
BULKSP = dict(
    blocks=2_000_000, A=2048, rate=1 / 3, bg=1, modulation="QPSK", esn0=0.4,
    iterations=8, algorithm="sum-product", schedule="flooding",
    batch_per_device=256, steps_per_call=32,
)
BULKLBRM = dict(
    blocks=2_000_000, A=4000, rate=1 / 3, bg=1, modulation="QPSK", esn0=-0.3,
    iterations=12, algorithm="min-sum", schedule="layered", N_L=2, I_LBRM=1,
    TBS_LBRM=6000, batch_per_device=256, steps_per_call=32,
)
BULKCBGTI = dict(
    blocks=2_000_000, A=7650, rate=1 / 3, bg=2, modulation="QPSK", esn0=-0.5,
    iterations=8, algorithm="min-sum", schedule="layered", rv_sequence=(0, 2),
    cbgti_seq=((), (0,)), batch_per_device=256, steps_per_call=32,
)


def _merge(protocol: dict, overrides: dict) -> dict:
    """``protocol`` with ``overrides``; a dict-valued part is merged with a
    dict override one level down.  Unknown keys raise."""
    unknown = set(overrides) - set(protocol)
    if unknown:
        raise TypeError(f"unknown protocol keys {sorted(unknown)}")
    out = dict(protocol)
    for k, v in overrides.items():
        out[k] = {**protocol[k], **v} if isinstance(protocol[k], dict) else v
    return out


def _cut(overrides: dict) -> str:
    """A description's note of a protocol cut by overrides ('' for none)."""
    return f"  CUT from the full protocol: {overrides!r}." if overrides else ""


def _sweep(p: dict, results_dir: str, device, **kw):
    """``bler_vs_snr`` at one (BG, rate, A) of protocol ``p``: its points."""
    from ..parallel.sweep import bler_vs_snr

    args = {k: v for k, v in p.items() if k not in ("A", "rate", "bg", "curves")}
    (pts,) = bler_vs_snr(A=[p["A"]], rate=[p["rate"]], bg=[p["bg"]], **args, **kw,
                         results_dir=results_dir, device=device).values()
    return pts


def _curve_points(points):
    return {
        "esn0_db": [p.esn0_db for p in points],
        "bler": [p.bler for p in points],
        "block_errors": [p.block_errors for p in points],
        "blocks": [p.blocks for p in points],
    }


def headline(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """The headline waterfall; its record holds its points for spvsms.  Its
    results file goes beside the artifact, as the JAX stage's does."""
    check_out_path(out_dir)
    p = _merge(HEADLINE, overrides)
    pts = _sweep(p, out_dir, device)
    dump(out_dir, "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json", {
        "description": (
            "Headline reference config (plot_BLER_vs_SNR.m defaults): "
            f"BG{p['bg']}, A={p['A']}, R={p['rate']:.4g}, {p['modulation']}, "
            f"rv=[0], {p['schedule']} {p['algorithm']}, {p['iterations']} "
            "iterations, early termination, Es/N0 from "
            f"{p['esn0_start']:g} dB in {p['esn0_delta']:g} dB steps to BLER "
            f"<= {p['target_bler']:g}, {p['batch_per_device']} x "
            f"{p['steps_per_call']} blocks per call. Measured with the port's "
            f"flooding kernel (backend 'auto') on {card_label(device)}, seed "
            f"{p['seed']}, >={p['target_block_errors']} block errors per point."
            + _cut(overrides)
        ),
        "semantics": semantics_fingerprint(),
        **_curve_points(pts),
    })
    return {"blocks": sum(pt.blocks for pt in pts), "points": pts}


def spvsms(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, sp_points=None,
           **overrides):
    """SP flooding vs NMS flooding vs NMS layered on the headline config;
    ``sp_points`` reuses the headline stage's curve (the same protocol)."""
    check_out_path(out_dir)
    p = _merge(SPVSMS, overrides)
    out = {
        "description": (
            f"Algorithm comparison on the headline config (BG{p['bg']} "
            f"A={p['A']} R={p['rate']:.4g} {p['modulation']}, {p['iterations']} "
            f"iterations, >={p['target_block_errors']} block errors/point, "
            f"{p['batch_per_device']} x {p['steps_per_call']} blocks per call, "
            f"seed {p['seed']}, on {card_label(device)}): flooding sum-product "
            "vs flooding normalized min-sum (alpha=0.8125) vs the layered "
            "normalized min-sum kernel (backend 'auto'; the key keeps the JAX "
            "golden's name).  Layered converges ~2x per sweep, hence the much "
            "earlier waterfall at the same iteration budget." + _cut(overrides)
        ),
        "semantics": semantics_fingerprint(),
    }
    blocks = 0
    for name, algorithm, schedule in p["curves"]:
        if name == "SP-flooding" and sp_points is not None:
            pts = sp_points
        else:
            pts = _sweep(p, results_dir, device, algorithm=algorithm, schedule=schedule)
            blocks += sum(pt.blocks for pt in pts)
        out[name] = {"esn0_db": [pt.esn0_db for pt in pts],
                     "bler": [pt.bler for pt in pts]}
    dump(out_dir, "BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json", out)
    return {"blocks": blocks}


def config1(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """BASELINE config #1 through the flooding kernel (the plain 'fast'
    decoder on the CPU)."""
    check_out_path(out_dir)
    p = _merge(CONFIG1, overrides)
    pts = _sweep(p, results_dir, device)
    d = _curve_points(pts)
    d.pop("block_errors")
    dump(out_dir, "BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json", {
        "description": (
            f"BASELINE config #1: BG{p['bg']}, A={p['A']}, rate "
            f"{p['rate']:.4g}, {p['modulation']}, AWGN, flooding normalized "
            f"min-sum (alpha=0.8125) {p['iterations']} iterations, early "
            f"termination, >={p['target_block_errors']} block errors/point, "
            f"seed {p['seed']}, {p['batch_per_device']} x {p['steps_per_call']} "
            f"blocks per call. The port's flooding kernel (backend "
            f"'{p['backend']}', bit-exact to its plain 'fast' decoder, the JAX "
            f"stage's) on {card_label(device)}." + _cut(overrides)
        ),
        "semantics": semantics_fingerprint(),
        **d,
    })
    return {"blocks": sum(pt.blocks for pt in pts)}


def config2(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """BASELINE config #2's waterfall and the HARQ IR demonstration."""
    from ..parallel.montecarlo import MonteCarlo
    from ..parallel.sweep import _make_config, _simulate_point
    from ..utils.rng import make_generator

    check_out_path(out_dir)
    p = _merge(CONFIG2, overrides)
    w, h = p["waterfall"], p["harq"]
    out = {
        "description": (
            f"BASELINE config #2 (BG{w['bg']} A={w['A']} R={w['rate']:.4g} "
            f"{w['modulation']}, layered normalized min-sum {w['iterations']} it, "
            f"early termination, {w['batch_per_device']} x "
            f"{w['steps_per_call']} blocks per call) plus a HARQ "
            f"incremental-redundancy demonstration: A={h['A']} at rate "
            f"{h['rate']:g}, single transmission vs rv sequence (0,2,3,1) with "
            "LLR accumulation. A block counts as decoded at the first rv stage "
            "whose accumulated decode passes the TB CRC. Measured with the "
            f"port's layered kernel (backend 'auto') on {card_label(device)}, "
            f"seed {w['seed']}." + _cut(overrides)
        ),
        "semantics": semantics_fingerprint(),
    }
    pts = _sweep(w, results_dir, device)
    C = _make_config(w["A"], w["rate"], w["bg"], w["modulation"], (0,),
                     w["iterations"], w["algorithm"]).params.C
    out["BG1_A8448_layered_NMS_12it"] = {  # the JAX golden's key, as it is
        "esn0_db": [pt.esn0_db for pt in pts],
        "bler": [pt.bler for pt in pts],
        "blocks": [pt.blocks for pt in pts],
        "mean_iterations_per_cb": [pt.iterations / max(pt.blocks * C, 1) for pt in pts],
    }
    blocks = sum(pt.blocks for pt in pts)
    for name, rv_seq, esn0s, tbe in h["curves"]:
        cfg = _make_config(h["A"], h["rate"], h["bg"], h["modulation"], rv_seq,
                           h["iterations"], h["algorithm"], backend=h["backend"],
                           schedule=h["schedule"])
        mc = MonteCarlo(cfg, batch_per_device=h["batch_per_device"],
                        steps_per_call=h["steps_per_call"], device=device)
        generator = make_generator(h["seed"], device)
        bler = []
        for esn0 in esn0s:
            pt, _ = _simulate_point(mc, generator, esn0, tbe, True, h["max_blocks"])
            bler.append(pt.bler)
            blocks += pt.blocks
            print(f"{name} Es/N0={esn0:+.2f}: BLER={pt.bler:.4e} "
                  f"({pt.block_errors}/{pt.blocks})", flush=True)
        out[name] = {"esn0_db": list(esn0s), "bler": bler}
    dump(out_dir, "config2_and_harq.json", out)
    return {"blocks": blocks}


def benchcfg(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """Waterfalls of the bench configuration (QPSK R=1/3) and of 64QAM R=1/2."""
    check_out_path(out_dir)
    p = _merge(BENCHCFG, overrides)
    c = p["common"]
    curves = {name: _sweep({**c, **p[name]}, results_dir, device)
              for name in ("QPSK_R13", "QAM64_R12")}
    q = p["QPSK_R13"]
    dump(out_dir, "bench_path_bler.json", {
        "description": (
            f"BLER regression anchors for the throughput-bench path: BG{q['bg']} "
            f"A={q['A']}, layered normalized min-sum (alpha=0.8125) "
            f"{c['iterations']} iterations, early termination, "
            f"{c['batch_per_device']} x {c['steps_per_call']} blocks per call, "
            f"measured with the port's layered kernel (backend 'auto') on "
            f"{card_label(device)}, seed {c['seed']}, "
            f">={c['target_block_errors']} block errors/point.  QPSK at R=1/3 "
            "(the bench config) and 64QAM at R=1/2 (exact-LLR demod gate)."
            + _cut(overrides)
        ),
        "semantics": semantics_fingerprint(),
        **{name: _curve_points(pts) for name, pts in curves.items()},
    })
    return {"blocks": sum(pt.blocks for pts in curves.values() for pt in pts)}


def surface(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR,
            force_resume=False, **overrides):
    """BASELINE config #4: required-Es/N0 surface over A x rate.

    One downward sweep per (algorithm, rate, A) records every (Es/N0, BLER)
    point; the required Es/N0 at both targets is interpolated in the log
    domain from the same sweep (plot_SNR_vs_A.m:175).  Checkpoints into the
    artifact after every (algorithm, rate); a rerun skips the curves already
    there when the artifact's ``semantics`` stamp is the current one (or
    with ``force_resume``), and drops them otherwise."""
    import numpy as np

    from ..parallel.montecarlo import MonteCarlo
    from ..parallel.sweep import _make_config, _simulate_point
    from ..spec.tables import UnsupportedParameters
    from ..utils.rng import make_generator

    p = _merge(SURFACE, overrides)
    name = "SNR_vs_A_surface.json"
    path = check_out_path(os.path.join(out_dir, name))
    targets = p["targets"]
    out = {
        "description": (
            f"Required Es/N0 surface (BASELINE config #4): BG{p['bg']}, "
            f"{p['modulation']}, flooding BP {p['iterations']} iterations, early "
            f"termination, {p['target_block_errors']} block errors/point, "
            f"{p['esn0_delta']:g} dB steps, seed {p['seed']}, "
            f"{p['batch_per_device']} x {p['steps_per_call']} blocks per call, "
            f"the port's flooding kernels (backend 'auto') on "
            f"{card_label(device)}. A = {', '.join(map(str, p['A']))}; rates "
            f"{', '.join(r for r, _, _ in p['rates'])}; algorithms "
            f"{' and '.join(p['algorithms'])} (min-sum normalized, "
            "alpha=0.8125); targets BLER "
            f"{' and '.join(f'{t:g}' for t in targets)} interpolated in the "
            "log domain from one sweep per config (plot_SNR_vs_A.m:175). "
            "delta_ms_minus_sp_db is the min-sum penalty at BLER 1e-2 per "
            "point." + _cut(overrides)
        ),
        "A": list(p["A"]),
        "semantics": semantics_fingerprint(),
        "curves": {},
    }
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev.get("semantics") == out["semantics"] or force_resume:
            out["curves"] = prev.get("curves", {})
        elif prev.get("curves"):
            print("surface: decoder-semantics fingerprint changed "
                  f"({prev.get('semantics')} -> {out['semantics']}); "
                  "discarding previous curves (pass --force-resume to keep)")
    blocks = 0
    for algorithm in p["algorithms"]:
        for r_key, rate, start in p["rates"]:
            ckey = f"{algorithm}/{r_key}"
            if ckey in out["curves"]:
                print(f"skip {ckey} (already measured)")
                continue
            curve = {f"required_esn0_db_at_{t:g}": [] for t in targets}
            for A in p["A"]:
                try:
                    cfg = _make_config(A, rate, p["bg"], p["modulation"], (0,),
                                       p["iterations"], algorithm,
                                       backend=p["backend"], schedule=p["schedule"])
                except UnsupportedParameters as e:
                    for t in targets:
                        curve[f"required_esn0_db_at_{t:g}"].append(None)
                    print(f"{ckey} A={A}: skip ({e})")
                    continue
                mc = MonteCarlo(cfg, batch_per_device=p["batch_per_device"],
                                steps_per_call=p["steps_per_call"], device=device)
                generator = make_generator(p["seed"], device)
                esn0 = start
                found = False
                pts = []  # (esn0, bler)
                bler = 1.0
                while bler > min(targets):
                    pt, found = _simulate_point(
                        mc, generator, esn0, p["target_block_errors"], found,
                        p["max_blocks"], prior_bler=bler if bler < 1 else 0.0)
                    bler = pt.bler
                    blocks += pt.blocks
                    pts.append((esn0, max(bler, 0.5 / max(pt.blocks, 1))))
                    esn0 += p["esn0_delta"]
                es = np.array([q[0] for q in pts])
                bl = np.log10([q[1] for q in pts])
                for t in targets:
                    # first crossing below the target, log-interp like
                    # plot_SNR_vs_A.m:175
                    i = int(np.argmax(bl <= np.log10(t)))
                    if i == 0:
                        req = float(es[0])
                    else:
                        req = float(np.interp(np.log10(t), [bl[i], bl[i - 1]],
                                              [es[i], es[i - 1]]))
                    curve[f"required_esn0_db_at_{t:g}"].append(round(req, 4))
                print(f"{ckey} A={A}: " + ", ".join(
                    f"{t:g}->{curve[f'required_esn0_db_at_{t:g}'][-1]}"
                    for t in targets), flush=True)
            out["curves"][ckey] = curve
            dump(out_dir, name, out)  # checkpoint per (algorithm, rate)
    delta = {}
    for r_key, _, _ in p["rates"]:
        sp = out["curves"].get(f"sum-product/{r_key}")
        ms = out["curves"].get(f"min-sum/{r_key}")
        if sp and ms:
            delta[r_key] = [
                None if (a is None or b is None) else round(b - a, 4)
                for a, b in zip(sp["required_esn0_db_at_0.01"],
                                ms["required_esn0_db_at_0.01"])
            ]
    out["delta_ms_minus_sp_db"] = delta
    dump(out_dir, name, out)
    return {"blocks": blocks}


def snrvsa(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """plot_SNR_vs_A with the reference's defaults; its results file goes
    beside the artifact, as the JAX stage's does."""
    import torch

    from ..ops import decoder_cuda
    from ..parallel.sweep import snr_vs_a

    check_out_path(out_dir)
    p = _merge(SNRVSA, overrides)
    args = {k: v for k, v in p.items() if k not in ("A", "rate")}
    curve = snr_vs_a(A=p["A"], rate=[p["rate"]], **args, results_dir=out_dir,
                     device=device)[p["rate"]]
    dump(out_dir, "SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json", {
        "description": (
            "plot_SNR_vs_A reproduction (reference defaults, "
            f"plot_SNR_vs_A.m:37-49): BG{p['bg']}, R={p['rate']:.4g}, "
            f"{p['modulation']}, flooding sum-product {p['iterations']} "
            f"iterations, required Es/N0 at BLER={p['target_bler']:g}, "
            f"{p['target_block_errors']} block errors/point, {p['esn0_delta']:g} "
            "dB steps with log-domain interpolation, seed "
            f"{p['seed']}, {p['batch_per_device']} x {p['steps_per_call']} "
            "blocks per call. Measured with the port's flooding kernels "
            f"(backend 'auto') on {card_label(device)}." + _cut(overrides)
        ),
        "semantics": semantics_fingerprint(),
        "A": [a for a, _ in curve],
        "required_esn0_db": [e for _, e in curve],
    })
    # snr_vs_a returns no block counts: on the card every flooding launch
    # decodes one step's batch of code blocks (C = 1 on this curve); the
    # plain versions on the CPU launch nothing and are not counted
    counted = torch.device(device).type == "cuda"
    return {"blocks": decoder_cuda.LAUNCHES["ldpc_flooding"] * p["batch_per_device"]
            if counted else None}


def _bulk(name, protocol, out_dir, device, **overrides):
    """The port's bulk tool in a subprocess, as the JAX stage runs its own;
    its record holds the subprocess's decode launches."""
    p = _merge(protocol, overrides)
    path = check_out_path(os.path.join(out_dir, name))
    argv = [sys.executable, "-m", "ldpc_3gpp_tpu_torch.tools.bulk_montecarlo",
            "--out", path, "--device", str(device)]
    for key, value in p.items():
        flag = {"N_L": "--N-L", "I_LBRM": "--I-LBRM", "TBS_LBRM": "--TBS-LBRM",
                "cbgti_seq": "--cbgti-seq"}.get(key, "--" + key.replace("_", "-"))
        if key == "cbgti_seq":
            argv += [flag, json.dumps([list(c) for c in value])]
        elif key == "rv_sequence":
            argv += [flag, *map(str, value)]
        else:
            argv += [flag, repr(value) if isinstance(value, float) else str(value)]
    os.makedirs(out_dir, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
    run = subprocess.run(argv, check=True, capture_output=True, text=True, env=env)
    print(run.stdout, end="", flush=True)
    launches = {}
    for line in run.stdout.splitlines():
        if line.startswith('{"launches"'):
            launches = json.loads(line)["launches"]
    with open(path) as f:
        result = json.load(f)
    if overrides:
        result["description"] += _cut(overrides)
        dump(out_dir, name, result)
    return {"blocks": result["blocks"], "launches": launches}


def bulk(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """Re-measure bulk_montecarlo.json (BG1 A=1000 256QAM, 15.75 dB)."""
    return _bulk("bulk_montecarlo.json", BULK, out_dir, device, **overrides)


def bulksp(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """bulk_sp_montecarlo.json: sum-product flooding, BG1 A=2048, 0.4 dB."""
    return _bulk("bulk_sp_montecarlo.json", BULKSP, out_dir, device, **overrides)


def bulklbrm(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """bulk_lbrm_montecarlo.json: N_L=2 and a limiting LBRM buffer."""
    return _bulk("bulk_lbrm_montecarlo.json", BULKLBRM, out_dir, device, **overrides)


def bulkcbgti(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """bulk_cbgti_montecarlo.json: rv (0, 2) with per-stage CBGTI ((), (0,))."""
    return _bulk("bulk_cbgti_montecarlo.json", BULKCBGTI, out_dir, device, **overrides)


# tools/regen_goldens.py:464-496: ``run_sweep()`` at its defaults (3 trials of
# 2 calls per row), the rows of ``bench.sweep_rows``
BENCH_SWEEP = dict(trials=3, reps=2, steps=None)


def bench_sweep(out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR, **overrides):
    """bench_sweep.json: the early-termination throughput economics (decoded
    Mbit/s and mean iterations per TB against Es/N0, against the iteration
    budget, and the non-flagship rows) of ``bench.py --sweep``.  Overrides:
    the protocol's keys, and ``names`` to measure some rows only."""
    from ..bench import ROW_KEYS, run_sweep

    check_out_path(out_dir)
    names = overrides.pop("names", None)
    p = _merge(BENCH_SWEEP, overrides)
    rows = run_sweep(device=device, names=names, **p)
    cut = dict(overrides, **({"names": names} if names is not None else {}))
    dump(out_dir, "bench_sweep.json", {
        "description": (
            "Early-termination throughput economics (python -m "
            f"ldpc_3gpp_tpu_torch.bench --sweep) on {card_label(device)}: decoded "
            "info Mbit/s, TB/s, mean BP iterations/TB and observed BLER per row, "
            f"best of {p['trials']} trials of {p['reps']} calls per host fetch.  Rows: "
            "flagship (BG1 A=8424 Z=384 R=1/3 QPSK layered NMS 12 it) vs Es/N0 "
            "-1..+4 dB; flagship vs iteration budget {4,8,12,25} at +1 dB; BG2 "
            "A=2048 Z=208 SP-flooding 8 it (reference comm.LDPCDecoder semantics) "
            "at +2 dB; the same config SP-LAYERED at +2 dB; small-Z BG2 A=600 Z=72 "
            "layered NMS at +2 dB (the row keeps the JAX name 'packed'; the port's "
            "rule packs no codewords at Z=72); flagship 2-stage HARQ IR at -2 dB.  "
            "Each row at the JAX rows' batch x steps (64-256 steps of 128 blocks, "
            "512 at Z=72).  TB/s are host-clock times of host-bound steps and move "
            "between calls; the mean iterations and the BLER are the rows' "
            "statistics." + _cut(cut)
        ),
        "semantics": semantics_fingerprint(),
        "rows": [{k: r[k] for k in ROW_KEYS} for r in rows],
    })
    return {"blocks": sum(r["blocks"] for r in rows)}


STAGES = {
    "headline": headline, "spvsms": spvsms, "config1": config1, "config2": config2,
    "benchcfg": benchcfg, "surface": surface, "snrvsa": snrvsa, "bulk": bulk,
    "bulksp": bulksp, "bulklbrm": bulklbrm, "bulkcbgti": bulkcbgti,
    "bench_sweep": bench_sweep,
}

#: the port's docs that quote the headline protocol: (path under the root,
#: the heading that starts the port's part of it, or None for the whole)
PORT_DOCS = (
    ("README.md", "## The PyTorch/CUDA port"),
    ("PERF.md", None),
    (os.path.join(".claude", "skills", "verify", "SKILL.md"), "## The PyTorch/CUDA port"),
)


def doc_consistency(root=None) -> list:
    """The port's doc guard, the counterpart of the JAX tool's: every
    "<batch>x<steps>" the port's docs quote for the headline protocol
    matches ``bench.py``'s ``HEADLINE_BATCH`` and ``HEADLINE_STEPS``.

    Rule: in the port's part of each doc of ``PORT_DOCS``, a line that has
    the word 'headline' and a token ``<HEADLINE_BATCH>x<digits>`` must quote
    the current protocol, unless it is marked 'historical'; and each doc
    must state the current protocol at least once.  Returns the problems
    (empty: consistent); ``main`` refuses to regenerate while there are any.
    """
    import re

    from ..bench import HEADLINE_BATCH, HEADLINE_STEPS

    proto = f"{HEADLINE_BATCH}x{HEADLINE_STEPS}"
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tok = re.compile(rf"\b{HEADLINE_BATCH}x(\d+)\b")
    problems = []
    for rel, heading in PORT_DOCS:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            problems.append(f"{rel}: missing")
            continue
        with open(path) as f:
            lines = f.read().splitlines()
        start = 0
        if heading is not None:
            found = [i for i, line in enumerate(lines) if line.startswith(heading)]
            if not found:
                problems.append(f"{rel}: no section {heading!r}")
                continue
            start = found[0]
        mentions_proto = False
        for i, line in enumerate(lines[start:], start + 1):
            if proto in line:
                mentions_proto = True
            if "headline" not in line or "historical" in line:
                continue
            for m in tok.finditer(line):
                if m.group(0) != proto:
                    problems.append(
                        f"{rel}:{i}: stale headline protocol {m.group(0)!r} "
                        f"(bench.py uses {proto}): {line.strip()!r}")
        if not mentions_proto:
            problems.append(f"{rel}: never states the current headline protocol {proto}")
    return problems


def restamp(out_dir=DEFAULT_DIR):
    """Refresh the ``semantics`` stamp of every stamped artifact in
    ``out_dir`` without re-measuring; nothing else of a file changes.

    Only legitimate after a change shown neutral on the card: the
    ``goldens`` phase of ``chip_smoke.py`` re-measures points of these
    artifacts against them."""
    current = semantics_fingerprint()
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and "semantics" in data:
            if data["semantics"] != current:
                data["semantics"] = current
                dump(out_dir, os.path.basename(path), data)
                print(f"restamped {os.path.basename(path)} -> {current}")
            else:
                print(f"{os.path.basename(path)} already current")


def run_stage(name, out_dir=DEFAULT_DIR, device="cuda", results_dir=RESULTS_DIR,
              **kw) -> dict:
    """Run stage ``name``; returns its record (seconds, blocks, blocks/s,
    decode launches by kernel, card; headline's also its points), printed
    as one JSON line."""
    import torch

    from ..ops import decoder_cuda

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    decoder_cuda.reset_launches()
    t0 = time.perf_counter()
    rec = STAGES[name](out_dir=out_dir, device=dev, results_dir=results_dir, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    rec = {"stage": name, "seconds": round(seconds, 3), **rec,
           "blocks_per_s": (None if rec["blocks"] is None
                            else round(rec["blocks"] / seconds, 1)),
           "launches": rec.get("launches", dict(decoder_cuda.LAUNCHES)),
           "card": card_label(dev)}
    print(json.dumps({k: v for k, v in rec.items() if k != "points"}), flush=True)
    return rec


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.regen_goldens",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("stages", nargs="*", default=[], choices=list(STAGES) + [[]])
    ap.add_argument("--out-dir", default=DEFAULT_DIR)
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help="results files of the sweeps but headline and snrvsa")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--force-resume", action="store_true",
                    help="reuse checkpointed surface curves even if the "
                         "decoder-semantics fingerprint changed")
    ap.add_argument("--restamp", action="store_true",
                    help="refresh stamps on existing artifacts without "
                         "re-measuring (only after the card showed the change "
                         "neutral)")
    args = ap.parse_args(argv)
    check_out_path(args.out_dir)
    if args.restamp:
        restamp(args.out_dir)
        return []
    problems = doc_consistency()
    if problems:
        raise SystemExit(
            "doc/protocol drift (fix the docs or bench.py first; the "
            "regeneration owns the artifacts the docs quote):\n  "
            + "\n  ".join(problems))
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    records = []
    sp_points = None
    for name in args.stages or list(STAGES):
        kw = {}
        if name == "spvsms":
            kw["sp_points"] = sp_points
        if name == "surface":
            kw["force_resume"] = args.force_resume
        rec = run_stage(name, args.out_dir, dev, args.results_dir, **kw)
        sp_points = rec.pop("points", sp_points)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
