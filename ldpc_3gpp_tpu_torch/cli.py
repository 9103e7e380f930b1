"""Console entry points of the port (pyproject [project.scripts]).

The framework's equivalent of the reference's "clone, addpath, run
plot_BLER_vs_SNR" workflow (README.md:5): after ``pip install -e .`` the
commands run from any cwd:

- ``ldpc-torch-bler-sweep`` — plot_BLER_vs_SNR.m equivalent (parallel/sweep.py)
- ``ldpc-torch-snr-vs-a``   — plot_SNR_vs_A.m equivalent
- ``ldpc-torch-testbench``  — randomized differential conformance vs the C++
                              oracle (testbench.m equivalent, plus decode fuzz)
- ``ldpc-torch-plot``       — overlay of reference-format results files
- ``ldpc-torch-bench``      — the single-GPU throughput benchmark (bench.py)

Every command that simulates takes ``--device`` (default ``cuda``: the CUDA
kernels; it raises where there is no card) and ``--device cpu`` runs the
plain PyTorch versions.  Results and plots land under ``--results-dir``
(default ``results/`` in the current working directory).
"""
from __future__ import annotations

import argparse
import os
import sys


def bler_sweep_main(argv=None):
    """CLI mirror of the reference's plot_BLER_vs_SNR.m.

    Run with no arguments for the reference's default experiment
    (plot_BLER_vs_SNR.m:30-42): BG2, A=3842, R=1/3, QPSK, 8 iterations.
    Writes results/*.txt (EsN0<TAB>BLER per line) and a PNG plot.
    """
    ap = argparse.ArgumentParser(description=bler_sweep_main.__doc__)
    ap.add_argument("--A", type=int, nargs="+", default=[3842])
    ap.add_argument("--rate", type=float, nargs="+", default=[1 / 3])
    ap.add_argument("--bg", type=int, nargs="+", default=[2])
    ap.add_argument("--modulation", default="QPSK",
                    choices=["BPSK", "QPSK", "16QAM", "64QAM", "256QAM"])
    ap.add_argument("--rv-sequence", type=int, nargs="+", default=[0])
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--target-block-errors", type=int, default=3)
    ap.add_argument("--target-bler", type=float, default=1e-3)
    ap.add_argument("--esn0-start", type=float, default=0.0)
    ap.add_argument("--esn0-delta", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--algorithm", default="sum-product",
                    choices=["sum-product", "min-sum", "offset-min-sum"])
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--schedule", default="flooding",
                    choices=["flooding", "layered"])
    ap.add_argument("--N-L", type=int, default=1, dest="N_L")
    ap.add_argument("--I-LBRM", type=int, default=0, dest="I_LBRM")
    ap.add_argument("--TBS-LBRM", type=int, default=None, dest="TBS_LBRM")
    ap.add_argument("--CBGTI", type=int, nargs="*", default=(), dest="CBGTI")
    ap.add_argument("--batch-per-device", type=int, default=256)
    ap.add_argument("--steps-per-call", type=int, default=2)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--live-plot", action="store_true")
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ldpc_3gpp_tpu_torch.parallel.sweep import bler_vs_snr

    curves = bler_vs_snr(
        A=args.A, rate=args.rate, bg=args.bg, modulation=args.modulation,
        rv_sequence=tuple(args.rv_sequence), iterations=args.iterations,
        target_block_errors=args.target_block_errors,
        target_bler=args.target_bler, esn0_start=args.esn0_start,
        esn0_delta=args.esn0_delta, seed=args.seed, algorithm=args.algorithm,
        backend=args.backend, schedule=args.schedule,
        N_L=args.N_L, I_LBRM=args.I_LBRM, TBS_LBRM=args.TBS_LBRM,
        CBGTI=tuple(args.CBGTI),
        batch_per_device=args.batch_per_device,
        steps_per_call=args.steps_per_call, results_dir=args.results_dir,
        resume=args.resume, live_plot=args.live_plot, device=args.device,
    )
    if not args.no_plot and curves:
        from ldpc_3gpp_tpu_torch.utils.plotting import plot_bler_curves

        path = plot_bler_curves(
            curves, out_path=os.path.join(args.results_dir, "BLER_vs_SNR.png")
        )
        print(f"plot: {path}")


def snr_vs_a_main(argv=None):
    """CLI mirror of the reference's plot_SNR_vs_A.m.

    Run with no arguments for the reference's default experiment
    (plot_SNR_vs_A.m:37-49): A=1000..8000, BG1, R=1/3, QPSK, 50 iterations,
    required Es/N0 at BLER 1e-2.  Writes results/*.txt (A<TAB>EsN0) and a PNG.
    """
    ap = argparse.ArgumentParser(description=snr_vs_a_main.__doc__)
    ap.add_argument("--A", type=int, nargs="+",
                    default=list(range(1000, 8001, 1000)))
    ap.add_argument("--rate", type=float, nargs="+", default=[1 / 3])
    ap.add_argument("--bg", type=int, default=1)
    ap.add_argument("--modulation", default="QPSK",
                    choices=["BPSK", "QPSK", "16QAM", "64QAM", "256QAM"])
    ap.add_argument("--rv-sequence", type=int, nargs="+", default=[0])
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--target-block-errors", type=int, default=100)
    ap.add_argument("--target-bler", type=float, default=1e-2)
    ap.add_argument("--esn0-start", type=float, default=-2.0)
    ap.add_argument("--esn0-delta", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--algorithm", default="sum-product",
                    choices=["sum-product", "min-sum", "offset-min-sum"])
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--schedule", default="flooding",
                    choices=["flooding", "layered"])
    ap.add_argument("--N-L", type=int, default=1, dest="N_L")
    ap.add_argument("--I-LBRM", type=int, default=0, dest="I_LBRM")
    ap.add_argument("--TBS-LBRM", type=int, default=None, dest="TBS_LBRM")
    ap.add_argument("--CBGTI", type=int, nargs="*", default=(), dest="CBGTI")
    ap.add_argument("--batch-per-device", type=int, default=256)
    ap.add_argument("--steps-per-call", type=int, default=2)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--live-plot", action="store_true")
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ldpc_3gpp_tpu_torch.parallel.sweep import snr_vs_a

    curves = snr_vs_a(
        A=tuple(args.A), rate=tuple(args.rate), bg=args.bg,
        modulation=args.modulation, rv_sequence=tuple(args.rv_sequence),
        iterations=args.iterations,
        target_block_errors=args.target_block_errors,
        target_bler=args.target_bler, esn0_start=args.esn0_start,
        esn0_delta=args.esn0_delta, seed=args.seed, algorithm=args.algorithm,
        backend=args.backend, schedule=args.schedule,
        N_L=args.N_L, I_LBRM=args.I_LBRM, TBS_LBRM=args.TBS_LBRM,
        CBGTI=tuple(args.CBGTI),
        batch_per_device=args.batch_per_device,
        steps_per_call=args.steps_per_call, results_dir=args.results_dir,
        resume=args.resume, live_plot=args.live_plot, device=args.device,
    )
    if not args.no_plot and curves:
        from ldpc_3gpp_tpu_torch.utils.plotting import plot_snr_vs_a as _plot

        path = _plot(
            curves, out_path=os.path.join(args.results_dir, "SNR_vs_A.png")
        )
        print(f"plot: {path}")


#: trials per soak subprocess: each chunk is a fresh process with a seed of
#: its own, so a crash stays in its chunk and ``--seed`` reproduces it alone.
_SOAK_CHUNK = {"encode": 25, "decode": 5}


def _soak(args):
    """``ldpc-torch-testbench --soak``: grow the differential-fuzz population.

    Runs ``--trials`` encode trials AND ``--trials`` decode trials, split
    into small fresh-subprocess chunks (_SOAK_CHUNK each) with one
    consecutive seed per chunk — by default continuing above the highest
    seed the tally has seen, so every soak run extends the population with
    FRESH draws.  On success, appends one entry to the cumulative tally at
    ``--tally`` (default ``<results-dir>/soak_tally_torch.json``), stamped
    with the port's ``semantics_fingerprint()``, and prints the running
    totals.  Any mismatch aborts before the tally is written (the chunk
    subprocess exits nonzero), so the tally only ever counts clean trials.
    """
    import json
    import subprocess
    import sys as _sys
    import time

    from ldpc_3gpp_tpu_torch.utils.fingerprint import semantics_fingerprint

    tally_path = args.tally or os.path.join(
        args.results_dir, "soak_tally_torch.json")
    tally = {"description": (
        "Cumulative differential-fuzz tally of the PyTorch/CUDA port "
        "(ldpc-torch-testbench --soak): every entry is a clean run of N "
        "encode + N decode trials vs the independent C++ oracle at the "
        "recorded seed range and device; the semantics field records the "
        "port's decoder fingerprint each population segment was fuzzed "
        "at."), "entries": []}
    if os.path.exists(tally_path):
        with open(tally_path) as f:
            tally = json.load(f)
    used = [s for e in tally["entries"]
            for s in range(e["seed_range"][0], e["seed_range"][1] + 1)]
    seed = args.seed if args.seed is not None else (max(used, default=-1) + 1)
    first = seed
    # the chunks import this package from the same tree as this process
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for mode, flag in (("encode", []), ("decode", ["--decode"])):
        left = args.trials
        while left > 0:
            n = min(_SOAK_CHUNK[mode], left)
            argv = ["--trials", str(n), "--seed", str(seed),
                    "--device", args.device] + flag
            if args.max_a is not None:
                argv += ["--max-a", str(args.max_a)]
            r = subprocess.run(
                [_sys.executable, "-c",
                 "import sys; from ldpc_3gpp_tpu_torch.cli import "
                 "testbench_main; testbench_main(sys.argv[1:])", *argv],
                env=env,
            )
            if r.returncode != 0:
                raise SystemExit(
                    f"soak chunk failed ({mode}, seed {seed}, {n} trials): "
                    "differential mismatch or crash — tally NOT extended"
                )
            left -= n
            seed += 1
    tally["entries"].append({
        "seed_range": [first, seed - 1],
        "encode_trials": args.trials,
        "decode_trials": args.trials,
        "device": args.device,
        "semantics": semantics_fingerprint(),
        "date": time.strftime("%Y-%m-%d"),
    })
    enc = sum(e["encode_trials"] for e in tally["entries"])
    dec = sum(e["decode_trials"] for e in tally["entries"])
    lo = min([e["seed_range"][0] for e in tally["entries"]])
    hi = max([e["seed_range"][1] for e in tally["entries"]])
    os.makedirs(os.path.dirname(tally_path) or ".", exist_ok=True)
    with open(tally_path, "w") as f:
        json.dump(tally, f, indent=1)
        f.write("\n")
    print(f"SOAK TALLY: {enc} encode + {dec} decode clean differential "
          f"trials across seeds {lo}..{hi} "
          f"(this run: seeds {first}..{seed - 1}, {args.trials}/mode)")


def testbench_main(argv=None):
    """Randomized differential conformance testbench.

    The framework's equivalent of the reference's testbench.m: draws random
    TS38.212 parameter combinations (testbench.m:21-36), encodes a random
    transport block with the port's chain on ``--device``, and asserts
    bit-exact equality against the independent native C++ oracle
    (native/golden.cpp).  Runs until the trial budget is exhausted (or
    forever with --trials 0), printing one line per config like the
    reference (testbench.m:70).

    With --decode, fuzzes the full RECEIVE chain instead (beyond the
    reference, whose testbench covers only the encoder), starting from
    complex channel symbols so the modulator AND demodulator are inside the
    differential loop: each trial modulates with the oracle's f64 TS38.211
    constellations, adds host-side noise, then (a) checks the port's
    modulator against the oracle constellation, (b) checks the port's
    exact-LLR demodulator against the oracle's independent
    full-constellation f64 LSE demod to f32 rounding, and (c) runs the
    TB-level decode on BOTH sides from the same (port-demodulated) LLRs —
    deinterleave, Chase combining, HARQ buffers, filler pinning, BP decode,
    CB/TB CRC gating compared bit-for-bit against the independent scalar
    C++ oracle (nr_golden_decode), every algorithm including sum-product
    (the oracle's phi and the port's share one float32 recipe).  The
    decode is the port's default path, backend 'auto': the CUDA kernels on
    the card, their plain versions with ``--device cpu``.  Decode consumes
    the shared f32 LLRs because the f64 oracle demod and the f32 port
    demod differ by ulps, which would legitimately diverge BP trajectories;
    demod correctness is the (b) tolerance check (gate 1e-5 relative — an
    LLR-scale bug is rel O(1)).
    """
    ap = argparse.ArgumentParser(description=testbench_main.__doc__)
    ap.add_argument("--trials", type=int, default=100, help="0 = run forever")
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed (default 0; in --soak mode the default "
                         "continues where the recorded tally left off)")
    ap.add_argument("--max-a", type=int, default=None,
                    help="max transport block size; defaults to 100000 "
                         "(testbench.m draws <=100000) for encode trials and "
                         "25000 (C up to 3) for --decode trials")
    ap.add_argument("--decode", action="store_true",
                    help="fuzz the symbol-level receive chain against the "
                         "C++ oracle instead")
    ap.add_argument("--soak", action="store_true",
                    help="run --trials encode AND --trials decode fuzz "
                         "trials in fresh-subprocess chunks over consecutive "
                         "fresh seeds, then extend the cumulative tally "
                         "(--tally): the differential population keeps "
                         "growing run over run (testbench.m's run-forever "
                         "usage model)")
    ap.add_argument("--tally", default=None,
                    help="the --soak tally file (default "
                         "<results-dir>/soak_tally_torch.json)")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.soak:
        return _soak(args)
    if args.seed is None:
        args.seed = 0
    if args.max_a is None:
        args.max_a = 25000 if args.decode else 100000

    import numpy as np
    import torch

    from ldpc_3gpp_tpu_torch.models.decoder import (
        decode_transport_block, init_harq_state,
    )
    from ldpc_3gpp_tpu_torch.models.encoder import encode_transport_block
    from ldpc_3gpp_tpu_torch.ops.channel import esn0_to_variance
    from ldpc_3gpp_tpu_torch.ops.modulation import demodulate, modulate
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
    from ldpc_3gpp_tpu_torch.spec.tables import UnsupportedParameters
    from ldpc_3gpp_tpu_torch.utils.device import resolve_device
    from ldpc_3gpp_tpu_torch.utils.golden import (
        golden_decode, golden_demodulate, golden_encode, golden_init_state,
        golden_modulate,
    )

    dev = resolve_device(args.device)

    def encode(p, a):
        bits = torch.from_numpy(a[None].astype(np.int8)).to(dev)
        return encode_transport_block(p, bits)[0].cpu().numpy()

    rng = np.random.default_rng(args.seed)
    trial = 0
    tested = 0
    while args.trials == 0 or trial < args.trials:
        trial += 1
        # random draw mirroring testbench.m:21-36
        R = rng.uniform(0.15, 0.95)
        A = int(rng.integers(1, args.max_a + 1))
        Q_m = int(rng.choice([1, 2, 4, 6, 8]))
        N_L = int(rng.integers(1, 5))
        rv_id = int(rng.integers(0, 4))
        I_LBRM = int(rng.integers(0, 2))
        TBS_LBRM = int(rng.integers(A, 2 * A + 1)) if I_LBRM else None
        BG = 2 if (A <= 292 or (A <= 3824 and R <= 0.67) or R <= 0.25) else 1
        G = int(round(A / R / (N_L * Q_m)) * N_L * Q_m)
        try:
            p = LDPCParams(BG=BG, A=A, G=G, Q_m=Q_m, N_L=N_L, rv_id=rv_id,
                           I_LBRM=I_LBRM, TBS_LBRM=TBS_LBRM)
        except UnsupportedParameters as e:
            print(f"[{trial}] skip BG{BG} A={A} G={G}: {e}")
            continue

        if args.decode:
            mod = {1: "BPSK", 2: "QPSK", 4: "16QAM", 6: "64QAM",
                   8: "256QAM"}[Q_m]
            algorithm = ("min-sum", "offset-min-sum", "sum-product")[trial % 3]
            iters = int(rng.integers(2, 13))
            esn0 = float(rng.uniform(-1.0, 5.0))
            n_rv = int(rng.integers(1, 4))
            rv_seq = [rv_id] + [int(r) for r in rng.integers(0, 4, n_rv - 1)]
            a = rng.integers(0, 2, A, dtype=np.uint8)
            st_t = init_harq_state(p, device=dev) if n_rv > 1 else None
            st_c = (golden_init_state(BG, A, G, Q_m, N_L, rv_seq[0],
                                      I_LBRM, TBS_LBRM)
                    if n_rv > 1 else None)
            var_t = esn0_to_variance(esn0, device=dev)
            var = float(var_t)
            for i_rv, rv in enumerate(rv_seq):
                prv = p.with_rv(rv)
                g = encode(prv, a)
                # channel symbols from the ORACLE's f64 constellation; the
                # port's modulator is checked against it, then host-side
                # f64 noise produces the rx both demodulators consume
                tx = golden_modulate(g, mod)
                tx_t = modulate(torch.from_numpy(g.astype(np.int8)).to(dev),
                                mod).cpu().numpy()
                if np.max(np.abs(tx_t - tx)) > 1e-7:
                    print(f"[{trial}] MODULATE MISMATCH: {mod} "
                          f"max abs {np.max(np.abs(tx_t - tx)):.3e}")
                    sys.exit(1)
                noise = rng.normal(0.0, np.sqrt(var / 2), (2, tx.size))
                rx = tx + noise[0] + 1j * noise[1]
                rx_t = torch.from_numpy(rx.astype(np.complex64)).to(dev)
                llr_t = demodulate(rx_t, mod, var_t, "exact")
                llr = llr_t.cpu().numpy().astype(np.float32)
                llr_c = golden_demodulate(rx, mod, var, "exact")
                rel = np.max(np.abs(llr - llr_c) /
                             np.maximum(np.abs(llr_c), 1.0))
                if rel > 1e-5:
                    print(f"[{trial}] DEMOD MISMATCH: {mod} var={var:.3g} "
                          f"max rel {rel:.3e}")
                    sys.exit(1)
                res_t = decode_transport_block(
                    prv, llr_t, state=st_t, iterations=iters,
                    algorithm=algorithm, backend="auto")
                res_c = golden_decode(
                    BG, A, G, Q_m, llr, N_L, rv, I_LBRM, TBS_LBRM,
                    iterations=iters, algorithm=algorithm, state=st_c)
                same = (
                    np.array_equal(res_t.a_hat.cpu().numpy(), res_c.a_hat)
                    and bool(res_t.tb_ok) == res_c.tb_ok
                    and np.array_equal(res_t.cb_crc_ok.cpu().numpy(),
                                       res_c.cb_crc_ok)
                    and np.array_equal(res_t.parity_ok.cpu().numpy(),
                                       res_c.parity_ok)
                    and np.array_equal(res_t.iterations.cpu().numpy(),
                                       res_c.iterations)
                )
                if n_rv > 1:
                    same = same and all(
                        np.array_equal(x.cpu().numpy().ravel(), y.ravel())
                        for x, y in zip(res_t.state, res_c.state))
                    st_t, st_c = res_t.state, res_c.state
                if not same:
                    print(f"[{trial}] DECODE MISMATCH: BG{BG} A={A} G={G} "
                          f"C={p.C} Z={p.Z_c} {mod} {algorithm} it={iters} "
                          f"rv_seq={rv_seq[:i_rv+1]} Es/N0={esn0:.2f}")
                    sys.exit(1)
            tested += 1
            print(f"[{trial}] ok decode BG{BG} A={A} C={p.C} Z={p.Z_c} {mod} "
                  f"{algorithm} it={iters} rvs={rv_seq} Es/N0={esn0:.2f} dB "
                  f"tb_ok={res_c.tb_ok}")
            continue

        a = rng.integers(0, 2, A, dtype=np.uint8)
        g_port = encode(p, a)
        g_gold = golden_encode(BG, A, G, Q_m, a, N_L, rv_id, I_LBRM, TBS_LBRM)
        if not np.array_equal(g_port, g_gold):
            first = int(np.nonzero(g_port != g_gold)[0][0])
            print(f"[{trial}] MISMATCH at bit {first}: BG{BG} A={A} G={G} "
                  f"Q_m={Q_m} N_L={N_L} rv={rv_id} LBRM={I_LBRM}/{TBS_LBRM}")
            sys.exit(1)
        tested += 1
        print(f"[{trial}] ok BG{BG} A={A} G={G} Q_m={Q_m} N_L={N_L} "
              f"rv={rv_id} C={p.C} Z={p.Z_c} LBRM={I_LBRM}")
    print(f"{tested}/{trial} configs bit-exact vs native oracle")


def bench_main(argv=None):
    """Single-GPU throughput benchmark (see ldpc_3gpp_tpu_torch/bench.py)."""
    from ldpc_3gpp_tpu_torch.bench import main as _main

    _main(argv)


def plot_results_main(argv=None):
    """Overlay reference-format results files on one PNG.

    Accepts any mix of ``BLER_vs_SNR_*.txt`` or ``SNR_vs_A_*.txt`` files
    (one kind per figure) — the tab-separated layout this framework shares
    with the MATLAB reference, so curves from either implementation (or
    from several seeded instances, the reference's manual-aggregation
    workflow, plot_BLER_vs_SNR.m:23-27) can be compared directly.
    """
    ap = argparse.ArgumentParser(description=plot_results_main.__doc__)
    ap.add_argument("files", nargs="+", help="results/*.txt files")
    ap.add_argument("--out", default="results/overlay.png")
    ap.add_argument("--title", default="3GPP New Radio LDPC code, AWGN")
    ap.add_argument("--vline", action="append", default=[],
                    help="dashed reference line '<x>[:<label>]' — e.g. a "
                         "density-evolution threshold from "
                         "golden/de_thresholds.json next to its measured "
                         "waterfall (drawn horizontal on SNR-vs-A "
                         "figures, where the threshold is the asymptote)")
    args = ap.parse_args(argv)

    from ldpc_3gpp_tpu_torch.utils.plotting import plot_results_files

    path = plot_results_files(args.files, args.out, args.title,
                              vlines=args.vline)
    print(f"plot: {path}")
