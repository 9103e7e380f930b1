#!/usr/bin/env python3
"""Protograph Monte-Carlo density evolution: decoder-independent thresholds.

The port's counterpart of the repository's ``tools/density_evolution.py``.
It computes the asymptotic decoding threshold of the exact NR LDPC ensembles
the measured golden curves use, by Monte-Carlo density evolution: a
statistical method that shares no code with the decoders (no codewords, no
lifted parity-check matrix, no BP kernel; only the base-graph edge lists,
which are TS38.212 data).  It validates itself first against a published
number, the sum-product threshold of the (3,6)-regular ensemble on
BPSK/AWGN, sigma* = 0.8809 (Richardson & Urbanke, "The capacity of
low-density parity-check codes under message-passing decoding", IEEE Trans.
IT 2001, Table II).

Method: for every directed base-graph edge, S message samples represent the
density.  Check updates run in the gamma domain for sum-product (phi(x) =
-ln tanh(x/2), leave-one-out by sum subtraction, sign by parity) or as
normalized min-sum (leave-one-out minimum from prefix and suffix running
minima, alpha 0.8125), on the protograph, with every edge's samples rolled by
a fresh random offset each iteration (the cycle-free assumption).  Channel
classes per base column model the exact configuration: the two punctured
systematic columns (LLR 0), filler fractions (known bits, +CAP, kept out of
the error estimate) and per-position transmission counts k (LLR ~ N(k m,
2 k m), m = 2/var for QPSK) from a replay of the Section 5.4.2.1 circular
buffer read (NRLDPCEncoder.m:187-195).

The iteration is plain PyTorch on an explicit device, every draw from an
explicit ``torch.Generator``; per-row and per-column reductions are batched
through padded (segments, max degree) edge tables, summed left to right in
edge order (``ops/decoder.py::_segment_sum``).  Library ``log``/``tanh`` are
used: density evolution is statistical, not bit-exact.  Every evaluation
runs in this process; the JAX tool's fresh process per evaluation guarded
against the remote TPU client dying under long programs, which has no
counterpart here.

Usage:
  python -m ldpc_3gpp_tpu_torch.tools.density_evolution
      [--configs reg36 bg1_r13 bg2_headline] [--samples 100000]
      [--out results/torch/golden/de_thresholds.json] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.artifacts import DEFAULT_DIR, card_label, check_out_path

#: published external anchor (Richardson & Urbanke 2001, Table II)
REG36_PUBLISHED_SIGMA = 0.8809

CAP = 30.0  # message clip; quantized-DE practice (thresholds insensitive)

#: every configuration ``main`` knows, with the Es/N0 (dB) its bracket starts at
CONFIGS = {"reg36": 3.0, "bg1_r13": 1.0, "bg1_r13_nms": 1.0, "bg1_r23": 4.0,
           "bg1_r15": -2.0, "bg2_headline": 1.0}


def tx_counts_d(params) -> np.ndarray:
    """Per-d-position transmission count for rv 0..: replay of the
    NaN-skipping circular-buffer read (NRLDPCEncoder.m:187-195)."""
    N_cb, E, k0 = params.N_cb, params.E_r[0], params.k_0
    lo, hi = params.filler_range_d
    counts = np.zeros(params.N, np.int32)
    k, j = k0, 0
    while j < E:
        pos = k % N_cb
        if not (lo <= pos < hi):
            counts[pos] += 1
            j += 1
        k += 1
    return counts


def column_classes(params):
    """Per base column: list of (fraction, kind) channel classes.

    kind: ('tx', k) = transmitted k times, ('known',) = filler.
    Columns 0..1 are the punctured systematic columns (k = 0).
    """
    Z, nc = params.Z_c, params.num_cols
    counts = tx_counts_d(params)
    lo, hi = params.filler_range_d
    classes = []
    for c in range(nc):
        if c < 2:
            classes.append([(1.0, ("tx", 0))])
            continue
        bins = {}
        known = 0
        for z in range(Z):
            i = (c - 2) * Z + z  # d-domain position
            if lo <= i < hi:
                known += 1
            else:
                k = int(counts[i])
                bins[k] = bins.get(k, 0) + 1
        cl = [(n / Z, ("tx", k)) for k, n in sorted(bins.items())]
        if known:
            cl.append((known / Z, ("known",)))
        classes.append(cl)
    return classes


class Ensemble:
    """Protograph + channel-class + BP-variant model for one DE run."""

    def __init__(self, rows, cols, classes, info_cols, name,
                 algorithm="sum-product", alpha=0.8125):
        self.rows = np.asarray(rows, np.int32)
        self.cols = np.asarray(cols, np.int32)
        self.classes = classes  # per column: [(fraction, kind)]
        self.info_cols = list(info_cols)
        self.name = name
        self.algorithm = algorithm  # 'sum-product' | 'min-sum' (normalized)
        self.alpha = float(alpha)  # NMS normalization (decoder default)
        self.n_rows = int(self.rows.max()) + 1
        self.n_cols = int(self.cols.max()) + 1
        self.row_edges = [np.nonzero(self.rows == r)[0]
                          for r in range(self.n_rows)]
        self.col_edges = [np.nonzero(self.cols == c)[0]
                          for c in range(self.n_cols)]
        # the JAX tool's gather orders: concatenating the per-row (per-column)
        # outputs and gathering with these rebuilds the edge-indexed array
        self.row_inv = np.argsort(np.concatenate(self.row_edges))
        self.col_inv = np.argsort(np.concatenate(self.col_edges))


def nr_ensemble(bg, A, rate, name, algorithm="sum-product"):
    from ..spec.params import LDPCParams
    from ..spec.tables import base_graph

    G = round(A / rate / 2) * 2  # QPSK
    p = LDPCParams(BG=bg, A=A, G=G, Q_m=2)
    rows, cols, _ = base_graph(bg, p.i_LS)
    return Ensemble(rows, cols, column_classes(p),
                    info_cols=range(p.num_sys_cols), name=name,
                    algorithm=algorithm), p


def reg36_ensemble():
    """(3,6)-regular rate-1/2 protograph: 3 all-ones rows over 6 columns."""
    rows = np.repeat(np.arange(3), 6)
    cols = np.tile(np.arange(6), 3)
    classes = [[(1.0, ("tx", 1))] for _ in range(6)]
    return Ensemble(rows, cols, classes, info_cols=range(6), name="reg36")


class Tables(NamedTuple):
    """An ensemble's index and channel-class tables on one device."""

    rows: torch.Tensor  # (E,) row of each edge
    cols: torch.Tensor  # (E,) column of each edge
    row_table: torch.Tensor  # (n_rows, max row degree) edges, padded with E
    col_table: torch.Tensor  # (n_cols, max column degree) edges, padded with E
    slot: torch.Tensor  # (E,) flat (row, position) slot of each edge in row_table
    class_hi: torch.Tensor  # (n_cols, classes) upper bound of each class's u interval
    class_lo: torch.Tensor  # (n_cols, classes) lower bound
    class_k: torch.Tensor  # (n_cols, classes) transmissions (0 for known and padding)
    class_known: torch.Tensor  # (n_cols, classes) bool, filler class
    info: torch.Tensor  # (n_info,) the information columns


def tables(ens: Ensemble, device) -> Tables:
    """``ens``'s tables as tensors on ``device``."""
    from ..ops.decoder import _segment_table

    E = len(ens.rows)
    row_table = _segment_table(ens.rows, ens.n_rows)
    slot = np.empty(E, np.int64)
    for r in range(ens.n_rows):
        for j, e in enumerate(row_table[r]):
            if e < E:
                slot[e] = r * row_table.shape[1] + j
    n_cls = max(len(cl) for cl in ens.classes)
    # a padding class has an empty interval [1, 1): u < 1 never falls in it
    lo = np.ones((ens.n_cols, n_cls), np.float32)
    hi = np.ones((ens.n_cols, n_cls), np.float32)
    k = np.zeros((ens.n_cols, n_cls), np.float32)
    known = np.zeros((ens.n_cols, n_cls), bool)
    for c, cl in enumerate(ens.classes):
        acc = 0.0  # accumulated as the JAX tool does, in Python floats
        for j, (frac, kind) in enumerate(cl):
            lo[c, j], hi[c, j] = acc, acc + frac
            acc += frac
            if kind == ("known",):
                known[c, j] = True
            else:
                k[c, j] = kind[1]

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    return Tables(t(ens.rows.astype(np.int64)), t(ens.cols.astype(np.int64)),
                  t(row_table), t(_segment_table(ens.cols, ens.n_cols)), t(slot),
                  t(hi), t(lo), t(k), t(known),
                  t(np.asarray(ens.info_cols, np.int64)))


def phi(x: torch.Tensor) -> torch.Tensor:
    """-ln tanh(x/2) with the argument clipped to [1e-12, CAP]."""
    x = torch.clamp(x, 1e-12, CAP)
    return -torch.log(torch.tanh(0.5 * x))


def channel(tab: Tables, m: float, u: torch.Tensor, n: torch.Tensor):
    """(n_cols, S) channel LLR samples and the mask of samples that count
    toward the error estimate (False for fillers), from uniform ``u`` and
    normal ``n`` draws of that shape: a sample of column c falls into the
    class whose interval holds its u."""
    val = torch.zeros_like(u)
    mask = torch.ones_like(u, dtype=torch.bool)
    for j in range(tab.class_k.shape[1]):
        sel = (u >= tab.class_lo[:, j:j + 1]) & (u < tab.class_hi[:, j:j + 1])
        known = tab.class_known[:, j:j + 1]
        k = tab.class_k[:, j:j + 1]
        samp = k * m + torch.sqrt(2.0 * k * m) * n
        val = torch.where(sel & known, torch.full_like(val, CAP), val)
        val = torch.where(sel & ~known & (k > 0), samp, val)
        mask = mask & ~(sel & known)
    return val, mask


def roll_edges(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Every edge's S samples rolled by its own offset: out[e, s] =
    x[e, (s + off[e]) mod S]."""
    S = x.shape[1]
    idx = (torch.arange(S, device=x.device)[None, :] + off[:, None]) % S
    return torch.gather(x, 1, idx)


def _check_update(tab: Tables, v: torch.Tensor, algorithm: str, alpha: float):
    """Check-to-variable messages (E, S) from variable-to-check ``v``."""
    from ..ops.decoder import _segment_sum

    neg = (v < 0).to(v.dtype)
    nsum = _segment_sum(neg, tab.row_table)[tab.rows]
    out_sgn = 1.0 - 2.0 * torch.remainder(nsum - neg, 2.0)
    if algorithm == "sum-product":
        mag = phi(torch.abs(v))
        msum = _segment_sum(mag, tab.row_table)[tab.rows]
        return out_sgn * torch.clamp(phi(msum - mag), max=CAP)
    # normalized min-sum: leave-one-out minimum from the running minima of
    # the row's edges before and after each edge
    mag = torch.abs(v)
    big = torch.full_like(mag[:1], 1e30)
    a = torch.cat([mag, big])[tab.row_table]  # (n_rows, d, S), padding 1e30
    pre = torch.cat([big.expand(a.shape[0], 1, -1),
                     torch.cummin(a, dim=1).values[:, :-1]], dim=1)
    suf = torch.cat([torch.flip(torch.cummin(torch.flip(a, [1]), dim=1).values,
                                [1])[:, 1:],
                     big.expand(a.shape[0], 1, -1)], dim=1)
    min_loo = torch.minimum(pre, suf).reshape(-1, v.shape[1])[tab.slot]
    return alpha * out_sgn * torch.clamp(min_loo, max=CAP)


def iterate(tab: Tables, v, off_v, off_u, ch, chmask, algorithm="sum-product",
            alpha=0.8125):
    """One DE iteration from the variable-to-check samples ``v`` (E, S) with
    the draws given: the per-edge roll offsets of the variable-to-check and
    the check-to-variable messages (E,), and the channel samples and their
    mask (n_cols, S).  Returns (the next variable-to-check samples, the
    error estimate over the information columns' unmasked samples)."""
    from ..ops.decoder import _segment_sum

    v = torch.clamp(roll_edges(v, off_v), -CAP, CAP)
    u = roll_edges(_check_update(tab, v, algorithm, alpha), off_u)
    usum = _segment_sum(u, tab.col_table)  # (n_cols, S)
    vnew = ch[tab.cols] + usum[tab.cols] - u
    app = (ch + usum)[tab.info]
    mask = chmask[tab.info].to(v.dtype)
    bad = (app < 0).to(v.dtype) * mask
    pe = bad.sum() / torch.clamp(mask.sum(), min=1.0)
    return torch.clamp(vnew, -CAP, CAP), pe


class Evolver:
    """Density evolution of one ensemble at S samples per edge on ``device``,
    every draw from a ``torch.Generator`` on that device."""

    def __init__(self, ens: Ensemble, S: int, device):
        self.ens, self.S, self.device = ens, S, torch.device(device)
        self.tab = tables(ens, self.device)
        self.E = len(ens.rows)

    def draw_channel(self, gen: torch.Generator, m: float):
        shape = (self.ens.n_cols, self.S)
        u = torch.rand(shape, generator=gen, device=self.device)
        n = torch.randn(shape, generator=gen, device=self.device)
        return channel(self.tab, m, u, n)

    def init(self, gen: torch.Generator, m: float) -> torch.Tensor:
        """First variable-to-check samples: the channel LLRs."""
        ch, _ = self.draw_channel(gen, m)
        return ch[self.tab.cols]

    def step(self, gen: torch.Generator, v: torch.Tensor, m: float):
        offs = torch.randint(0, self.S, (2, self.E), generator=gen, device=self.device)
        ch, mask = self.draw_channel(gen, m)
        return iterate(self.tab, v, offs[0], offs[1], ch, mask,
                       self.ens.algorithm, self.ens.alpha)


def converges(evolver: Evolver, m: float, max_iters: int, p_target: float,
              seed: int, iters_per_block: int = 20):
    """(converged, iterations run, last error estimate): iterate at channel
    mean ``m`` until the error estimate, read every ``iters_per_block``
    iterations, is at most ``p_target``, or ``max_iters`` have run."""
    gen = torch.Generator(device=evolver.device)
    gen.manual_seed(seed)
    v = evolver.init(gen, m)
    pe = 1.0
    for b in range(max_iters // iters_per_block):
        for _ in range(iters_per_block):
            v, pe_t = evolver.step(gen, v, m)
        pe = float(pe_t)  # the block's one host synchronisation
        if pe <= p_target:
            return True, (b + 1) * iters_per_block, pe
    return False, max_iters, pe


def m_of(db: float) -> float:
    """Mean channel LLR per transmission at Es/N0 ``db`` (m = 2/var)."""
    return 2.0 / 10.0 ** (-db / 10.0)


def find_threshold(ens, S=200_000, max_iters=600, p_target=1e-4,
                   tol_db=0.02, start_db=3.0, seed=0, verbose=True,
                   iters_per_block=20, device="cuda"):
    """Bisect Es/N0 (dB) to the convergence threshold: walk up from
    ``start_db`` in 0.5 dB steps to the first success, down to the first
    failure, then bisect to ``tol_db``.  Returns (threshold, resolution).

    For reg36 the 'Es/N0' is defined via m = 2/var with var = 10^(-x/10);
    ``sigma_from_esn0`` converts to the published units."""
    from ..utils.device import resolve_device

    evolver = Evolver(ens, S, resolve_device(device))

    def ev(db):
        good, it, pe = converges(evolver, m_of(db), max_iters, p_target, seed,
                                 iters_per_block)
        if verbose:
            print(f"  {ens.name} {db:+.3f} dB: {'ok' if good else 'fail'} "
                  f"it={it} Pe={pe:.2e}", flush=True)
        return good

    hi = start_db
    while not ev(hi):
        hi += 0.5
    lo = hi - 0.5
    while ev(lo):
        hi = lo
        lo -= 0.5
    while hi - lo > tol_db:
        mid = 0.5 * (lo + hi)
        if ev(mid):
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi), hi - lo


def sigma_from_esn0(db):
    """reg36 units: our channel draws LLR ~ N(m, 2m) with m = 2/var.

    BPSK with noise std sigma has LLR ~ N(2/sigma^2, 4/sigma^2), i.e.
    m = 2/sigma^2 -> sigma = sqrt(var).  The published (3,6) threshold is
    quoted as sigma* = 0.8809."""
    return float(np.sqrt(10.0 ** (-db / 10.0)))


def _make_ensemble(name):
    if name == "reg36":
        return reg36_ensemble(), None
    if name == "bg1_r13":
        return nr_ensemble(1, 8424, 1 / 3, "bg1_r13")
    if name == "bg1_r13_nms":
        return nr_ensemble(1, 8424, 1 / 3, "bg1_r13_nms",
                           algorithm="min-sum")
    if name == "bg1_r23":
        return nr_ensemble(1, 8424, 2 / 3, "bg1_r23")
    if name == "bg1_r15":
        return nr_ensemble(1, 8424, 0.2, "bg1_r15")
    if name == "bg2_headline":
        return nr_ensemble(2, 3842, 1 / 3, "bg2_headline")
    raise SystemExit(f"unknown config {name}")


def _row(name, thr, res, p):
    """The artifact's row for configuration ``name`` (the JAX tool's fields
    and descriptions, tools/density_evolution.py:478-559)."""
    if name == "reg36":
        sigma = sigma_from_esn0(thr)
        return {
            "description": "(3,6)-regular BPSK/AWGN SP threshold — "
                           "the published-number validation row",
            "threshold_sigma": round(sigma, 4),
            "published_sigma": REG36_PUBLISHED_SIGMA,
            "delta_db": round(20 * np.log10(REG36_PUBLISHED_SIGMA / sigma), 4),
            "resolution_db": res,
        }
    descriptions = {
        "bg1_r13": "NR BG1 R=1/3 QPSK (flagship/SNR-vs-A ensemble, A=8424 "
                   "geometry: full buffer, no fillers)",
        "bg1_r13_nms": "NR BG1 R=1/3 QPSK under NORMALIZED MIN-SUM "
                       "(alpha=0.8125, the decoders' default) — the asymptotic "
                       "anchor for the min-sum half of the measured SNR-vs-A "
                       "surface",
        "bg1_r23": "NR BG1 R=2/3 QPSK (the surface's high-rate corner: only "
                   "~half the circular buffer is transmitted, so this anchors "
                   "the DE channel-class model in its puncture-heaviest regime)",
        "bg1_r15": "NR BG1 R=1/5 QPSK (the surface's low-rate corner: G=42120 > "
                   "N_cb, so the circular buffer WRAPS and most positions "
                   "transmit twice — the only regime exercising the k>1 "
                   "repetition channel classes, Chase-combined LLR ~ N(2m, 4m))",
        "bg2_headline": "NR BG2 A=3842 R=1/3 QPSK (the headline BLER golden's "
                        "exact ensemble geometry: Z=%d, fillers and "
                        "partial-column transmission modeled as channel-class "
                        "mixtures)" % p.Z_c,
    }
    row = {"description": descriptions[name], "threshold_esn0_db": round(thr, 3),
           "resolution_db": res, "Z": p.Z_c}
    if name == "bg1_r13_nms":
        row.update(algorithm="min-sum", alpha=0.8125)
    return row


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.density_evolution",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", nargs="*", choices=list(CONFIGS),
                    default=["reg36", "bg1_r13", "bg2_headline"])
    ap.add_argument("--samples", type=int, default=100_000)
    ap.add_argument("--max-iters", type=int, default=600)
    ap.add_argument("--p-target", type=float, default=1e-4)
    ap.add_argument("--tol-db", type=float, default=0.02)
    ap.add_argument("--iters-per-block", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(DEFAULT_DIR, "de_thresholds.json"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    check_out_path(args.out)
    from ..utils.device import resolve_device
    from ..utils.fingerprint import semantics_fingerprint

    dev = resolve_device(args.device)
    rows = {}
    out = None
    for name in args.configs:
        ens, p = _make_ensemble(name)
        thr, res = find_threshold(
            ens, S=args.samples, max_iters=args.max_iters, p_target=args.p_target,
            tol_db=args.tol_db, start_db=CONFIGS[name], seed=args.seed,
            iters_per_block=args.iters_per_block, device=dev)
        rows[name] = _row(name, thr, res, p)
        print(json.dumps({name: rows[name]}), flush=True)
        # written after every configuration, merged into an earlier partial run
        out = {
            "description": (
                "Monte-Carlo density-evolution SP thresholds (ldpc_3gpp_tpu_torch/"
                "tools/density_evolution.py, plain PyTorch on "
                f"{card_label(dev)}): decoder-independent asymptotic anchors "
                "for the measured golden curves, validated against the "
                "published (3,6)-regular sigma*=0.8809 (Richardson & Urbanke "
                "2001).  Measured finite-length waterfalls must sit ABOVE "
                "these and approach them as A grows."),
            "samples": args.samples,
            "max_iters": args.max_iters,
            "p_target": args.p_target,
            "backend": dev.type,
            "semantics": semantics_fingerprint(),
            "rows": rows,
        }
        if os.path.exists(args.out):
            with open(args.out) as f:
                merged = dict(json.load(f).get("rows", {}))
            merged.update(rows)
            out["rows"] = merged
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
