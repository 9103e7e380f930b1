"""Adaptive Monte-Carlo sweeps.

Host-side equivalents of the reference's experiment layer: the sequential
SNR-stepping decisions stay in Python (they are inherently adaptive,
plot_BLER_vs_SNR.m:104-171), while every inner trial batch runs as one
run of the device (parallel/montecarlo.py).

- ``bler_vs_snr``: BLER waterfall per (BG, R, A), stepping Es/N0 upward by
  ``esn0_delta`` until BLER <= ``target_bler``  (plot_BLER_vs_SNR.m).
- ``snr_vs_a``: required Es/N0 at ``target_bler`` as a function of A, with
  the reference's log-domain interpolation       (plot_SNR_vs_A.m:175).

Results append to tab-separated files under ``results/`` with the same
layout as the reference (EsN0\\tBLER per line / A\\tEsN0 per line), so its
downstream plotting/aggregation workflow carries over.  File names, line
formats, resume and repair are byte for byte those of the JAX package's
``parallel/sweep.py``; one ``torch.Generator`` per curve, seeded from
``seed``, takes the place of its split keys.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.chain import ChainConfig
from ..ops.modulation import Q_M
from ..spec.params import LDPCParams
from ..spec.tables import UnsupportedParameters
from ..utils.rng import make_generator
from .montecarlo import MonteCarlo


#: annotation prefix for capped (under-sampled) points in results files —
#: comment-style so the two-column reference format stays parseable by
#: downstream tooling that splits on whitespace per line.
CAPPED_PREFIX = "# capped"


def _scan_resume_file(fname, parse) -> Dict:
    """Parse + REPAIR a results file for resume.

    The file is append+flush-per-point, so the crash that resume recovers
    from can leave exactly one partial or blank trailing line.  A malformed
    INTERIOR line means the file is corrupt or foreign (not produced by this
    sweep) — resuming from it would silently drop data, so that raises.
    ``# capped``-annotated points (see CAPPED_PREFIX) are NOT treated as
    done: a resumed sweep re-simulates them in case the cap was raised.

    Repair (the file is rewritten in place when either applies):
    - a torn final line (no/partial fields, or missing its newline) is
      truncated — otherwise the first appended point would be glued onto
      the fragment, producing exactly the malformed interior line the next
      resume refuses;
    - capped data rows and their annotation lines are dropped, since the
      resumed sweep re-simulates those Es/N0 values and appends fresh rows —
      keeping both would leave duplicate x entries with contradictory
      values for downstream consumers of the reference-format file.
    """
    done = {}
    keep = []
    with open(fname) as fid:
        lines = fid.readlines()
    for i, line in enumerate(lines):
        if line.startswith(CAPPED_PREFIX):
            continue  # annotation of a capped row (dropped with its row)
        if line.startswith("#"):
            keep.append(line)  # other comment lines pass through
            continue
        parts = line.split()
        ok = len(parts) == 2 and line.endswith("\n")
        if ok:
            try:
                k, v = parse(parts)
            except ValueError:
                ok = False
        if not ok:
            if i == len(lines) - 1:
                continue  # torn final line from the crash being resumed
            raise ValueError(
                f"{fname}:{i + 1}: malformed interior line {line!r} — the "
                "results file is corrupt or from another tool; refusing to "
                "resume from partial data"
            )
        # a following "# capped" annotation voids the point for resume
        if i + 1 < len(lines) and lines[i + 1].startswith(CAPPED_PREFIX):
            continue
        keep.append(line)
        done[k] = v
    if keep != lines:
        with open(fname, "w") as fid:
            fid.writelines(keep)
    return done


@dataclasses.dataclass
class SweepPoint:
    esn0_db: float
    blocks: int
    block_errors: int
    bit_errors: int
    iterations: int
    # True when the point stopped on max_blocks_per_point with fewer than
    # target_block_errors — the BLER is an under-sampled estimate, not a
    # converged one (the reference runs to target unconditionally,
    # plot_BLER_vs_SNR.m:104-171; we cap, but never silently)
    capped: bool = False

    @property
    def bler(self) -> float:
        return self.block_errors / max(self.blocks, 1)


def _make_config(
    A: int,
    rate: float,
    bg: int,
    modulation: str,
    rv_sequence: Sequence[int],
    iterations: int,
    algorithm: str,
    N_L: int = 1,
    I_LBRM: int = 0,
    TBS_LBRM=None,
    CBGTI: Sequence[int] = (),
    **kw,
) -> ChainConfig:
    """Build the link config for one sweep cell.

    The full LDPCParams surface is reachable from the experiment layer —
    N_L, I_LBRM/TBS_LBRM, CBGTI are first-class tunables in the reference
    (NRLDPC.m:51-85) and pass straight through here; remaining ``kw`` are
    ChainConfig knobs (backend, schedule, ...).  G rounds to a multiple of
    N_L*Q_m as in plot_BLER_vs_SNR.m:94 generalized to the reference's
    G-validation rule (NRLDPC.m:551-559).
    """
    qm = Q_M[modulation]
    unit = qm * N_L
    G = round(A / rate / unit) * unit  # plot_BLER_vs_SNR.m:94
    params = LDPCParams(
        BG=bg, A=A, G=G, Q_m=qm, N_L=N_L, I_LBRM=I_LBRM,
        TBS_LBRM=TBS_LBRM, CBGTI=tuple(CBGTI),
    )
    return ChainConfig(
        params=params,
        modulation=modulation,
        rv_sequence=tuple(rv_sequence),
        iterations=iterations,
        algorithm=algorithm,
        **kw,
    )


def _simulate_point(
    mc: MonteCarlo,
    generator: torch.Generator,
    esn0: float,
    target_block_errors: int,
    found_start: bool,
    max_blocks: int,
    max_window: int = 8,
    prior_bler: float = 0.0,
    progress: bool = False,
) -> Tuple[SweepPoint, bool]:
    """Accumulate batches at one SNR until enough block errors are seen.

    Implements the reference's found-start fast-forward in batched form:
    before the first-ever success for this curve, a batch with zero
    successes abandons the point immediately (plot_BLER_vs_SNR.m:139-141).

    Once the point is known to need more samples, calls are pipelined in
    windows sized from the observed error rate (one host fetch per window,
    so the device is not left idle while the host decides).

    ``progress=True`` prints an interim line after every host fetch — the
    batched equivalent of the reference's per-block figure refresh
    (plot_BLER_vs_SNR.m:157-160): a low-BLER point can run for minutes,
    and without this the console is silent until it completes.
    """
    pt = SweepPoint(esn0, 0, 0, 0, 0)
    while pt.block_errors < target_block_errors and pt.blocks < max_blocks:
        if not found_start or max_window <= 1:
            c = mc.run(generator, esn0)
            if not found_start and c["block_errors"] == c["blocks"]:
                # no success yet anywhere, batch all errors: skip ahead
                pt = SweepPoint(esn0, c["blocks"], c["block_errors"],
                                c["bit_errors"], c["iterations"])
                return pt, False
            found_start = True
        else:
            need = target_block_errors - pt.block_errors
            if pt.block_errors > 0:
                rate = pt.block_errors / pt.blocks
            else:
                # previous point's BLER upper-bounds this (higher-SNR) one,
                # so the window it implies undershoots — safely so
                rate = prior_bler
            if rate > 0:
                per_call = rate * mc.blocks_per_run
                window = int(-(-need // max(per_call, 1e-9)))
            else:
                window = max_window  # no information: BLER is low, go wide
            headroom = -(-(max_blocks - pt.blocks) // mc.blocks_per_run)
            window = max(1, min(window, max_window, headroom))
            c = mc.run_pipelined(generator, esn0, window)
        pt.blocks += c["blocks"]
        pt.block_errors += c["block_errors"]
        pt.bit_errors += c["bit_errors"]
        pt.iterations += c["iterations"]
        if progress and pt.block_errors < target_block_errors:
            print(
                f"  ... Es/N0={esn0:+.2f} dB  {pt.block_errors}"
                f"/{target_block_errors} errors in {pt.blocks} blocks "
                f"(interim BLER {pt.bler:.3e})",
                flush=True,
            )
    # stopped on the sample cap short of the error target: the BLER estimate
    # is under-sampled and every consumer must be able to see that
    pt.capped = pt.block_errors < target_block_errors
    return pt, found_start


def bler_vs_snr(
    A: Sequence[int] = (3842,),
    rate: Sequence[float] = (1 / 3,),
    bg: Sequence[int] = (2,),
    modulation: str = "QPSK",
    rv_sequence: Sequence[int] = (0,),
    iterations: int = 8,
    target_block_errors: int = 3,
    target_bler: float = 1e-3,
    esn0_start: float = 0.0,
    esn0_delta: float = 0.5,
    seed: int = 0,
    algorithm: str = "sum-product",
    batch_per_device: int = 256,
    steps_per_call: int = 1,
    max_blocks_per_point: int = 1_000_000,
    results_dir: str = "results",
    resume: bool = False,
    verbose: bool = True,
    live_plot: bool = False,
    device="cuda",
    **chain_kw,
) -> Dict[tuple, List[SweepPoint]]:
    """BLER-vs-Es/N0 waterfalls; defaults match plot_BLER_vs_SNR.m:30-42.

    ``resume=True`` skips Es/N0 points already present in the results file
    (the reference's append-per-point crash recovery, plot_BLER_vs_SNR.m:165,
    made explicit).  ``live_plot=True`` re-renders
    ``results_dir/BLER_vs_SNR_live.png`` after every point (the reference's
    per-point figure refresh, plot_BLER_vs_SNR.m:157-160).

    Runs on a CUDA device unless ``device='cpu'`` is passed; raises if CUDA
    is asked for and absent.
    """
    os.makedirs(results_dir, exist_ok=True)
    out: Dict[tuple, List[SweepPoint]] = {}
    for bg_i in bg:
        for r_i in rate:
            for a_i in A:
                try:
                    cfg = _make_config(
                        a_i, r_i, bg_i, modulation, rv_sequence, iterations,
                        algorithm, **chain_kw,
                    )
                except UnsupportedParameters as e:
                    if verbose:
                        print(f"skip BG{bg_i} R={r_i} A={a_i}: {e}")
                    continue
                mc = MonteCarlo(
                    cfg,
                    batch_per_device=batch_per_device,
                    steps_per_call=steps_per_call,
                    device=device,
                )
                fname = os.path.join(
                    results_dir,
                    f"BLER_vs_SNR_{a_i}_{r_i:g}_{bg_i}_{modulation}_"
                    f"{iterations}_{target_block_errors}_{esn0_start:g}_{seed}.txt",
                )
                done_points = {}
                if resume and os.path.exists(fname):
                    done_points = _scan_resume_file(
                        fname, lambda p: (round(float(p[0]), 6), float(p[1]))
                    )
                generator = make_generator(seed, device)
                points: List[SweepPoint] = []
                esn0, bler, found_start = esn0_start, 1.0, False
                with open(fname, "a" if resume else "w") as fid:
                    while bler > target_bler:
                        if round(esn0, 6) in done_points:
                            bler = done_points[round(esn0, 6)]
                            found_start = found_start or bler < 1
                            if verbose:
                                print(f"resume: skipping {esn0:+.2f} dB "
                                      f"(BLER={bler:.3e})")
                            esn0 += esn0_delta
                            continue
                        pt, found_start = _simulate_point(
                            mc, generator, esn0, target_block_errors,
                            found_start, max_blocks_per_point,
                            prior_bler=bler if bler < 1 else 0.0,
                            progress=verbose,
                        )
                        points.append(pt)
                        bler = pt.bler
                        if bler < 1:
                            fid.write(f"{esn0:f}\t{bler:e}\n")
                            if pt.capped:
                                # annotation line: keeps the two-column
                                # reference format parseable while marking
                                # the estimate as under-sampled; resume
                                # re-simulates annotated points
                                fid.write(
                                    f"{CAPPED_PREFIX} {pt.block_errors}"
                                    f"/{target_block_errors} errors in "
                                    f"{pt.blocks} blocks\n"
                                )
                            fid.flush()
                        if pt.capped and verbose:
                            print(
                                f"WARNING: Es/N0={esn0:+.2f} dB hit "
                                f"max_blocks_per_point={max_blocks_per_point}"
                                f" with {pt.block_errors}/"
                                f"{target_block_errors} target errors — "
                                "BLER is an under-sampled estimate"
                            )
                        if live_plot:
                            from ..utils.plotting import plot_bler_curves

                            live = dict(out)
                            live[(bg_i, r_i, a_i)] = points
                            plot_bler_curves(
                                live,
                                os.path.join(results_dir,
                                             "BLER_vs_SNR_live.png"),
                            )
                        if verbose:
                            mean_it = pt.iterations / max(pt.blocks * cfg.params.C, 1)
                            print(
                                f"BG{bg_i} R={r_i:.3g} A={a_i} "
                                f"Es/N0={esn0:+.2f} dB  BLER={bler:.3e} "
                                f"({pt.block_errors}/{pt.blocks}, "
                                f"{mean_it:.1f} it/CB)"
                            )
                        esn0 += esn0_delta
                out[(bg_i, r_i, a_i)] = points
    return out


def snr_vs_a(
    A: Sequence[int] = tuple(range(1000, 8001, 1000)),
    rate: Sequence[float] = (1 / 3,),
    bg: int = 1,
    modulation: str = "QPSK",
    rv_sequence: Sequence[int] = (0,),
    iterations: int = 50,
    target_block_errors: int = 100,
    target_bler: float = 1e-2,
    esn0_start: float = -2.0,
    esn0_delta: float = 0.1,
    seed: int = 0,
    algorithm: str = "sum-product",
    batch_per_device: int = 256,
    steps_per_call: int = 1,
    max_blocks_per_point: int = 1_000_000,
    results_dir: str = "results",
    resume: bool = False,
    verbose: bool = True,
    live_plot: bool = False,
    device="cuda",
    **chain_kw,
) -> Dict[float, List[Tuple[int, float]]]:
    """Required Es/N0 at target BLER vs A; defaults match plot_SNR_vs_A.m:37-49.

    ``resume=True`` skips A values already present in the results file
    (append-per-point crash recovery, same contract as ``bler_vs_snr``).
    ``live_plot=True`` re-renders ``results_dir/SNR_vs_A_live.png`` after
    every A (plot_SNR_vs_A.m:177-184).

    Runs on a CUDA device unless ``device='cpu'`` is passed; raises if CUDA
    is asked for and absent.
    """
    os.makedirs(results_dir, exist_ok=True)
    out: Dict[float, List[Tuple[int, float]]] = {}
    for r_i in rate:
        fname = os.path.join(
            results_dir,
            f"SNR_vs_A_{target_bler:g}_{r_i:g}_{bg}_{modulation}_"
            f"{iterations}_{target_block_errors}_{seed}.txt",
        )
        done_as: Dict[int, float] = {}
        if resume and os.path.exists(fname):
            done_as = _scan_resume_file(
                fname, lambda p: (int(p[0]), float(p[1]))
            )
        curve: List[Tuple[int, float]] = []
        with open(fname, "a" if resume else "w") as fid:
            for a_i in A:
                if a_i in done_as:
                    curve.append((a_i, done_as[a_i]))
                    if verbose:
                        print(f"resume: skipping A={a_i} "
                              f"(required Es/N0 = {done_as[a_i]:.3f} dB)")
                    continue
                try:
                    cfg = _make_config(
                        a_i, r_i, bg, modulation, rv_sequence, iterations,
                        algorithm, **chain_kw,
                    )
                except UnsupportedParameters as e:
                    if verbose:
                        print(f"skip A={a_i}: {e}")
                    continue
                mc = MonteCarlo(
                    cfg,
                    batch_per_device=batch_per_device,
                    steps_per_call=steps_per_call,
                    device=device,
                )
                generator = make_generator(seed, device)
                esn0 = esn0_start - esn0_delta
                bler, prev_bler, prev_esn0 = 1.0, float("nan"), float("nan")
                found_start = False
                while bler > target_bler:
                    prev_esn0, esn0 = esn0, esn0 + esn0_delta
                    pt, found_start = _simulate_point(
                        mc, generator, esn0, target_block_errors,
                        found_start, max_blocks_per_point,
                        prior_bler=bler if bler < 1 else 0.0,
                        progress=verbose,
                    )
                    prev_bler, bler = bler, pt.bler
                # log-domain interpolation to the target (plot_SNR_vs_A.m:175).
                # A zero-error final point has no measurable BLER; floor it at
                # the resolution of the sample size so log10 stays finite
                # (otherwise interp would return prev_esn0 — an SNR whose
                # measured BLER was ABOVE target).
                bler_f = max(bler, 0.5 / max(pt.blocks, 1))
                required = float(
                    np.interp(
                        np.log10(target_bler),
                        [np.log10(bler_f), np.log10(prev_bler)],
                        [esn0, prev_esn0],
                    )
                )
                curve.append((a_i, required))
                fid.write(f"{a_i}\t{required:f}\n")
                if pt.capped:
                    # the final (below-target) point saturated the sample
                    # cap: its BLER — and therefore the interpolated
                    # required-Es/N0 — is an under-sampled estimate.  Floor
                    # at the sample resolution keeps interp conservative
                    # (biases required Es/N0 HIGH, never below the true
                    # requirement); the annotation voids the point for
                    # resume so a raised cap re-measures it.
                    fid.write(
                        f"{CAPPED_PREFIX} {pt.block_errors}"
                        f"/{target_block_errors} errors in {pt.blocks} "
                        f"blocks at the final point\n"
                    )
                    if verbose:
                        print(
                            f"WARNING: A={a_i} final point hit "
                            f"max_blocks_per_point with {pt.block_errors}/"
                            f"{target_block_errors} target errors — "
                            "required Es/N0 is an under-sampled estimate"
                        )
                fid.flush()
                if live_plot:
                    from ..utils.plotting import plot_snr_vs_a as _plot

                    live = dict(out)
                    live[r_i] = curve
                    _plot(live, os.path.join(results_dir, "SNR_vs_A_live.png"))
                if verbose:
                    print(f"A={a_i}: required Es/N0 = {required:.3f} dB")
        out[r_i] = curve
    return out
