"""Single-GPU throughput benchmark of the port (``ldpc-torch-bench``).

The counterpart of the JAX package's ``bench.py``.  Default mode prints ONE
JSON line with the headline number, with the JAX line's keys:

  {"metric": "decoded_info_mbps_per_chip", "value": N, "unit": "Mbit/s",
   "vs_baseline": N, "vs_measured_scalar_cpu": N, "detail": {...}}

The configuration is the north star's: BG1, Z=384 (A=8424), rate 1/3, QPSK,
layered normalized min-sum, 12 iterations, the full chain (encode, modulate,
AWGN, exact LLR demodulation, BP decode, CRC gates) at an Es/N0 near the
waterfall, so that early termination runs a realistic iteration mix.
``detail.backend`` names the card and its power limit; ``detail`` also holds
the median and the spread of the trials beside the best one, and the decode
launches.

``--sweep`` measures the early-termination throughput economics instead:
decoded Mbit/s and mean iterations per transport block against Es/N0 across
the waterfall, against the iteration budget, and for the non-flagship rows
(BG2 Z=208 sum-product in both schedules, BG2 Z=72 layered, a two-stage HARQ
row).  One JSON line per row; ``tools/regen_goldens.py bench_sweep`` pins the
rows to ``golden_torch/bench_sweep.json``, held to the JAX package's
``golden/bench_sweep.json`` by ``tests/test_torch_goldens.py``.

``vs_baseline`` is codewords/s over an estimated single-threaded MATLAB rate
for the same configuration (comm.LDPCDecoder sum-product, about 20
codewords/s; the reference publishes no numbers).  ``vs_measured_scalar_cpu``
is measured: the same configuration decoded by the independent single-core
C++ oracle (``native/golden.cpp`` ``nr_golden_decode``, flooding BP with
parity-check early termination), timed on this host just after the GPU
measurement.

The measurement protocol is the JAX one: a warm-up call, then ``trials``
trials, each ``reps`` calls of ``batch x steps`` blocks issued back to back
with ONE host fetch (``MonteCarlo.run_pipelined``), timed with the host clock
around that fetch; the best trial is the result.  Runs on the card unless
``--device cpu`` is given.

    python -m ldpc_3gpp_tpu_torch.bench [--sweep] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

MATLAB_CODEWORDS_PER_SEC_EST = 20.0  # documented assumption, see module docstring

#: the flagship operating point (BASELINE.json north star)
FLAGSHIP = dict(A=8424, rate=1 / 3, qm=2, bg=1)

#: the headline protocol (batch x steps per call).  Single source of truth:
#: the port's docs quoting "<batch>x<steps>" beside the word "headline" are
#: checked against these by ``tools/regen_goldens.py::doc_consistency``.
#: The JAX package's 128 x 2048 was tuned on its TPU.  On an H100 the step is
#: bound by its host-side launches (about 850 per step whatever the batch),
#: so TB/s grows with the batch until the device fills.  The port's
#: ``tools/exp_bench_scan.py`` on NVIDIA H100 80GB HBM3, 700 W (best of 3-4
#: trials; spread = max/min - 1 of the trials; two values: two calls):
#: 128:2048 13.4k TB/s (spread 5 %), 1024:256 89.2k / 99.8k (2 / 6 %),
#: 2048:128 155k / 153k (19 / 10 %), 4096:64 223k (8 %), 8192:32 247k / 244k
#: (0.1 / 8 %), 16384:16 255k (0.7 %).  16384 x 16 keeps the JAX protocol's
#: 262,144 blocks per call and is the fastest pair scanned, 3-4 % above
#: 8192 x 32, whose two calls differ by 1 % (PERF.md §5).
HEADLINE_BATCH = 16384
HEADLINE_STEPS = 16
#: Es/N0 of the headline, near the BG1 R=1/3 waterfall
HEADLINE_ESN0_DB = 1.0


def measure_scalar_cpu(A, G, qm, esn0_db, iterations, min_seconds=1.5):
    """Measured single-core scalar CPU baseline: the independent C++ oracle.

    Times ``native/golden.cpp``'s full TB decode chain (``nr_golden_decode``,
    through the port's own wrapper ``utils/golden.py``) at the bench
    configuration, on host-made QPSK channel LLRs at the same Es/N0 (the same
    numpy draws as the JAX package's, so the same LLRs), for normalized
    min-sum and sum-product.  Returns {algorithm: codewords_per_sec}.
    """
    import numpy as np

    from .utils.golden import golden_decode, golden_encode

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, size=A).astype(np.uint8)
    g = golden_encode(1, A, G, qm, a)
    # exact QPSK LLRs (positive => bit 0): y = s + n, llr = 2*sqrt(2)*y/var
    var = 10.0 ** (-esn0_db / 10.0)
    y = (1.0 - 2.0 * g.astype(np.float64)) / np.sqrt(2.0)
    y = y + rng.normal(0.0, np.sqrt(var / 2.0), size=G)
    llr = (2.0 * np.sqrt(2.0) / var * y).astype(np.float32)

    rates = {}
    for algorithm in ("min-sum", "sum-product"):
        # warm-up (also builds the oracle outside the timed region)
        golden_decode(1, A, G, qm, llr, iterations=iterations, algorithm=algorithm)
        n, elapsed = 0, 0.0
        t0 = time.perf_counter()
        while elapsed < min_seconds:
            golden_decode(1, A, G, qm, llr, iterations=iterations, algorithm=algorithm)
            n += 1
            elapsed = time.perf_counter() - t0
        rates[algorithm] = n / elapsed
    return rates


def _flagship_config(iterations=12, algorithm="min-sum", schedule="layered"):
    from .models.chain import ChainConfig
    from .spec.params import LDPCParams

    # A=8424 -> B=8448=K_cb: one code block, K'=8448, Z=384
    A, rate, qm = FLAGSHIP["A"], FLAGSHIP["rate"], FLAGSHIP["qm"]
    G = round(A / rate / qm) * qm
    params = LDPCParams(BG=FLAGSHIP["bg"], A=A, G=G, Q_m=qm)
    assert params.Z_c == 384 and params.C == 1
    return ChainConfig(
        params=params,
        modulation="QPSK",
        rv_sequence=(0,),
        iterations=iterations,
        algorithm=algorithm,
        early_termination=True,
        backend="auto",  # the CUDA kernels on the card
        schedule=schedule,  # BASELINE config #2: layered normalized min-sum
    )


def measure_throughput_detail(cfg, esn0, batch=128, steps=1024, trials=3, reps=4,
                              device="cuda", seed=0) -> dict:
    """``measure_throughput`` with what it saw: the blocks simulated per call
    (``MonteCarlo`` rounds a batch above 64 up to a multiple of 128), each
    trial's TB/s, and the decode launches of the timed trials by kernel and
    by (kernel, P, layout)."""
    from .ops import decoder_cuda
    from .parallel.montecarlo import MonteCarlo
    from .utils.device import resolve_device
    from .utils.rng import make_generator

    dev = resolve_device(device)
    mc = MonteCarlo(cfg, batch_per_device=batch, steps_per_call=steps, device=dev)
    generator = make_generator(seed, dev)
    mc.run(generator, esn0)  # warm-up: kernel build, caches; ends in a fetch
    per_call = mc.batch_per_device * mc.steps_per_call
    # the trials' launches (counted at launch, on the host), read as
    # differences: the counts are the caller's to set to 0
    launches0 = dict(decoder_cuda.LAUNCHES)
    by_p0 = dict(decoder_cuda.LAUNCHES_BY_P)
    times = []
    errs = blocks = iters = 0
    for _ in range(trials):
        t0 = time.perf_counter()
        # ``reps`` calls summed on the device; the one fetch is the sync point
        c = mc.run_pipelined(generator, esn0, calls=reps)
        times.append(time.perf_counter() - t0)
        errs += c["block_errors"]
        blocks += c["blocks"]
        iters += c["iterations"]
    rates = [per_call * reps / t for t in times]
    return {
        "tb_per_sec": per_call * reps / min(times),
        "mean_iterations_per_tb": iters / max(blocks, 1),
        "block_errors": errs,
        "blocks": blocks,
        "batch": mc.batch_per_device,
        "steps": mc.steps_per_call,
        "trials_tb_per_sec": rates,
        "median_tb_per_sec": statistics.median(rates),
        "spread": max(rates) / min(rates) - 1.0,
        "launches": {k: n - launches0.get(k, 0) for k, n in decoder_cuda.LAUNCHES.items()},
        "launches_by_p": {f"{k}/P={p}/layout={lay}": n - by_p0.get((k, p, lay), 0)
                          for (k, p, lay), n in sorted(decoder_cuda.LAUNCHES_BY_P.items())
                          if n > by_p0.get((k, p, lay), 0)},
    }


def measure_throughput(cfg, esn0, batch=128, steps=1024, trials=3, reps=4, device="cuda"):
    """Decoded-info throughput of one (config, Es/N0) cell on this card.

    Returns (transport_blocks_per_sec, mean_iterations_per_TB, block_errors,
    blocks), as the JAX package's function does: a warm-up call, then
    ``trials`` trials of ``reps`` calls issued back to back with one host
    fetch each, the best trial taken."""
    d = measure_throughput_detail(cfg, esn0, batch, steps, trials, reps, device)
    return d["tb_per_sec"], d["mean_iterations_per_tb"], d["block_errors"], d["blocks"]


def _headline(device="cuda", batch=HEADLINE_BATCH, steps=HEADLINE_STEPS, trials=4, reps=4,
              scalar_seconds=1.5) -> dict:
    """Measure and print the headline line; returns it.  The keywords cut
    the protocol (a test, ``chip_smoke.py``); the line then says so."""
    from .utils.artifacts import card_label
    from .utils.device import resolve_device

    dev = resolve_device(device)
    cfg = _flagship_config()
    A = cfg.params.A
    esn0 = HEADLINE_ESN0_DB
    d = measure_throughput_detail(cfg, esn0, batch=batch, steps=steps, trials=trials,
                                  reps=reps, device=dev)
    tb_per_sec = d["tb_per_sec"]
    info_mbps = tb_per_sec * A / 1e6

    # Measured single-core scalar C++ baseline at the same config (the
    # independent oracle; see measure_scalar_cpu).  Guarded: the headline
    # number must never depend on the host toolchain.
    try:
        cpu = measure_scalar_cpu(A, cfg.params.G, cfg.params.Q_m, esn0, cfg.iterations,
                                 min_seconds=scalar_seconds)
    except Exception as e:  # noqa: BLE001
        cpu = {}
        print(f"# scalar-cpu baseline unavailable: {type(e).__name__}: {e}")
    protocol = dict(batch=HEADLINE_BATCH, steps=HEADLINE_STEPS, trials=4, reps=4,
                    scalar_seconds=1.5)
    cuts = {k: v for k, v in dict(batch=batch, steps=steps, trials=trials, reps=reps,
                                  scalar_seconds=scalar_seconds).items()
            if v != protocol[k]}
    line = {
        "metric": "decoded_info_mbps_per_chip",
        "value": round(info_mbps, 3),
        "unit": "Mbit/s",
        "vs_baseline": round(tb_per_sec / MATLAB_CODEWORDS_PER_SEC_EST, 2),
        # measured ratio against the single-core scalar C++ oracle decoding
        # the same configuration; the MATLAB figure above is an estimate
        "vs_measured_scalar_cpu": (
            round(tb_per_sec / cpu["min-sum"], 2) if "min-sum" in cpu else None
        ),
        "detail": {
            "scalar_cpu_codewords_per_sec": {k: round(v, 3) for k, v in cpu.items()},
            "config": "BG1 A=8424 Z=384 R=1/3 QPSK min-sum 12it early-term",
            "esn0_db": esn0,
            "transport_blocks_per_sec": round(tb_per_sec, 2),
            "mean_iterations_per_tb": round(d["mean_iterations_per_tb"], 3),
            "block_errors": d["block_errors"],
            "blocks": d["blocks"],
            # the device the number was measured on: the card's name and
            # power limit (nvidia-smi), or the host CPU
            "backend": card_label(dev),
            # the headline is one operating point; its sensitivity is
            # measured by `--sweep` and pinned in the artifact below
            "et_economics": "golden_torch/bench_sweep.json",
            "protocol": f"{d['batch']}x{d['steps']} blocks per call, {reps} calls per "
                        f"fetch, best of {trials} trials",
            "median_transport_blocks_per_sec": round(d["median_tb_per_sec"], 2),
            "trials_transport_blocks_per_sec": [round(r, 2) for r in d["trials_tb_per_sec"]],
            "spread_max_over_min": round(d["spread"], 4),
            "launches": d["launches"],
            "launches_by_p": d["launches_by_p"],
            "cut": cuts or None,
        },
    }
    print(json.dumps(line), flush=True)
    return line


def sweep_rows():
    """The early-termination economics grid: (name, cfg, esn0, batch, steps).

    Rows (the JAX package's, field for field):
    - flagship against Es/N0 across the waterfall (-1..+4 dB; the BG1 R=1/3
      QPSK waterfall sits near +1 dB, plot_BLER_vs_SNR.m:30-42 spans the
      same way)
    - flagship against the iteration budget at the headline point
    - BG2 mid-Z (Z=208) sum-product flooding: the reference decoder's
      literal semantics (NRLDPCDecoder.m:120)
    - the same configuration, sum-product layered
    - small-Z (BG2 Z=72) layered min-sum (the JAX package packs this row's
      lanes; the port's rule decides by ``auto_codewords_per_block``)
    - flagship two-stage HARQ IR at -2 dB: the cost of a retransmission
    """
    from .models.chain import ChainConfig
    from .spec.params import LDPCParams

    def bg2_cfg(A, algorithm, schedule, iterations, qm=2):
        G = round(A * 3 / qm) * qm  # R = 1/3
        params = LDPCParams(BG=2, A=A, G=G, Q_m=qm)
        return ChainConfig(
            params=params, modulation="QPSK", rv_sequence=(0,),
            iterations=iterations, algorithm=algorithm,
            early_termination=True, backend="auto", schedule=schedule,
        )

    rows = []
    for esn0 in (-1.0, 0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0):
        rows.append(dict(
            name=f"flagship_esn0_{esn0:+.1f}",
            cfg=_flagship_config(), esn0=esn0,
            batch=128, steps=256,
        ))
    for it in (4, 8, 12, 25):
        rows.append(dict(
            name=f"flagship_iters_{it}",
            cfg=_flagship_config(iterations=it), esn0=1.0,
            batch=128, steps=256,
        ))
    # BG2 A=2048 -> K'=2064, K_b=10, Z=208
    rows.append(dict(
        name="bg2_z208_sumproduct_flooding",
        cfg=bg2_cfg(2048, "sum-product", "flooding", 8), esn0=2.0,
        batch=128, steps=64,
    ))
    rows.append(dict(
        name="bg2_z208_sumproduct_layered",
        cfg=bg2_cfg(2048, "sum-product", "layered", 8), esn0=2.0,
        batch=128, steps=256,
    ))
    # BG2 A=600 -> K'=616, K_b=9, Z=72
    rows.append(dict(
        name="bg2_z72_packed_layered",
        cfg=bg2_cfg(600, "min-sum", "layered", 12), esn0=2.0,
        batch=512, steps=256,
    ))
    flag_harq = _flagship_config()
    rows.append(dict(
        name="flagship_harq_rv02_esn0_-2.0",
        cfg=ChainConfig(
            params=flag_harq.params, modulation="QPSK",
            rv_sequence=(0, 2), iterations=12, algorithm="min-sum",
            early_termination=True, backend="auto", schedule="layered",
        ),
        esn0=-2.0, batch=128, steps=128,
    ))
    return rows


#: the keys of a sweep row, the JAX golden's
ROW_KEYS = ("name", "esn0_db", "iterations_budget", "algorithm", "schedule", "A", "Z",
            "BG", "info_mbps", "tb_per_sec", "mean_iterations_per_tb", "bler", "blocks")


def run_sweep(trials=3, reps=2, device="cuda", steps=None, names=None) -> list:
    """Measure every sweep row (or those in ``names``); returns their
    records with the JAX golden's keys (``ROW_KEYS``) and, under ``"seen"``,
    what the measurement saw (launches, the kernels' P, the trials).  One
    JSON line per row.  ``steps`` overrides every row's steps (a cut)."""
    from .ops import decoder_cuda
    from .utils.device import resolve_device

    dev = resolve_device(device)
    out = []
    for row in sweep_rows():
        if names is not None and row["name"] not in names:
            continue
        cfg = row["cfg"]
        d = measure_throughput_detail(
            cfg, row["esn0"], batch=row["batch"], steps=steps or row["steps"],
            trials=trials, reps=reps, device=dev,
        )
        rec = {
            "name": row["name"],
            "esn0_db": row["esn0"],
            "iterations_budget": cfg.iterations,
            "algorithm": cfg.algorithm,
            "schedule": cfg.schedule,
            "A": cfg.params.A,
            "Z": cfg.params.Z_c,
            "BG": cfg.params.BG,
            "info_mbps": round(d["tb_per_sec"] * cfg.params.A / 1e6, 2),
            "tb_per_sec": round(d["tb_per_sec"], 1),
            "mean_iterations_per_tb": round(d["mean_iterations_per_tb"], 3),
            "bler": round(d["block_errors"] / max(d["blocks"], 1), 6),
            "blocks": d["blocks"],
        }
        seen = {
            "block_errors": d["block_errors"],
            "protocol": f"{d['batch']}x{d['steps']} x {reps} calls per fetch, "
                        f"best of {trials}",
            "median_tb_per_sec": round(d["median_tb_per_sec"], 1),
            "spread_max_over_min": round(d["spread"], 4),
            "launches": d["launches"],
            "launches_by_p": d["launches_by_p"],
            "codewords_per_block": decoder_cuda.auto_codewords_per_block(
                cfg.params, d["batch"] * cfg.params.C, cfg.schedule),
        }
        print(json.dumps({**rec, "seen": seen}), flush=True)
        out.append({**rec, "seen": seen})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ldpc-torch-bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sweep", action="store_true",
                    help="measure the early-termination throughput economics "
                         "(one JSON line per row) instead of the headline")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    if args.sweep:
        run_sweep(device=args.device)
    else:
        _headline(device=args.device)


if __name__ == "__main__":
    main()
