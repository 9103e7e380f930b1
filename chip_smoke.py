#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port still starts on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout and holds each,
in every variant, against its plain PyTorch version on the card (exact
equality, tolerance 0, sum-product included; the kernels' ``phi`` is held
equal to the plain one bit for bit).  It drives the port's paths through the
kernels with the launch counts set to 0 before each and read after:

- P1: ``simulate_batch`` at BG1 A=8424 Z=384 QPSK, layered normalized
  min-sum, 12 iterations, early termination;
- P2: the default decoder (sum-product, flooding, the reference's literal
  semantics) at BG2 A=3842 G=11526 QPSK, 8 iterations, two code blocks;
- P3: BG2 A=2048 G=6144, sum-product, layered and flooding, 8 iterations;
- P4: P1 with ``message_dtype='bfloat16'``;
- one step each for the variants that no path above runs.

It gates block error rates and mean iteration counts against the measured
goldens, and times every kernel variant and the steps with CUDA events.

Every phase raises on failure (non-zero exit, no ``ok`` line).  One JSON
object per line; the line before the last holds ``{"kernels": [...]}`` and
the last is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# the float32 rate outside the tensor cores, which the decoder's
# integer/float32 lane operations are counted against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations the algorithm does per edge and lane in one update sweep:
# parity xor, subtract, magnitude and, sign xor, tournament min/max/min,
# compare, select, own-sign and/xor, add (the two per-row scalings are
# amortised over the row's edges).
OPS_PER_EDGE_LANE = 12
OPS_PER_EDGE_LANE_SYNDROME = 1
# Sum-product: one phi is 27 single operations (clamp, halve, the compares
# and selects of tanh and log, exponent split, multiplies, adds, one divide,
# negate) and 19 fused multiply-adds counted as two: 65.  Per edge and lane
# a sweep does two phi and 13 more (parity xor, subtract, abs, sign test and
# mask, the sum T, T - phi, max, sign parity and flip, add).
OPS_PER_PHI = 65
OPS_PER_EDGE_LANE_SUM_PRODUCT = 2 * OPS_PER_PHI + 13

FLAGSHIP = dict(BG=1, A=8424, G=25272, Q_m=2)
ITERATIONS = 12
MAIN_BATCH = 1024
MAIN_STEPS = 4
MAIN_ESN0_DB = 1.0

# P2: the reference's headline configuration (plot_BLER_vs_SNR.m defaults;
# golden/BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json): C=2, Z=208.
P2_FIELDS = dict(BG=2, A=3842, G=11526, Q_m=2)
P2_ITERATIONS = 8
P2_GOLDEN = "BLER_vs_SNR_BG2_A3842_R13_QPSK_8it_sumproduct.json"
# at most 45 block errors in 4,096 blocks at 1.0 dB: the golden rate 0.00435
# (107 of 24,576) gives a mean of 17.8; plus 5 sigma of both samples
P2_MAX_ERRORS = 45
# P3: golden/bench_sweep.json rows bg2_z208_sumproduct_{layered,flooding}
P3_FIELDS = dict(BG=2, A=2048, G=6144, Q_m=2)
P3_ESN0_DB = 2.0
P3_ITERATION_TOLERANCE = 0.15  # on the mean iterations per block

LAYERED_SOURCE = "ldpc_3gpp_tpu_torch/csrc/ldpc_layered.cu"
FLOODING_SOURCE = "ldpc_3gpp_tpu_torch/csrc/ldpc_flooding.cu"
TPU_KERNEL = "ldpc_3gpp_tpu/ops/decoder_pallas.py:264"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def noisy_d_tilde(params, modulation, esn0_db, n, seed, dev):
    """(n, C, N) circular-buffer LLRs of numpy-seeded blocks through the
    port's own encode / demodulate chain at ``esn0_db``; also the bits."""
    from ldpc_3gpp_tpu_torch.models.decoder import split_rate_matched_symbols
    from ldpc_3gpp_tpu_torch.models.encoder import encode_to_symbols
    from ldpc_3gpp_tpu_torch.ops.channel import esn0_to_variance

    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 2, (n, params.A)).astype(np.int8)).to(dev)
    noise_var = esn0_to_variance(esn0_db, device=dev)
    tx = encode_to_symbols(params, a, modulation)
    std = math.sqrt(float(noise_var) / 2.0)
    noise = (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape)) * std
    rx = tx + torch.from_numpy(noise.astype(np.complex64)).to(dev)
    return split_rate_matched_symbols(params, rx, modulation, noise_var), a


def require_equal(got, want, what) -> int:
    """Max abs difference over bits, parity flags and iteration counts of two
    decode results; raises unless it is 0 (the stated tolerance)."""
    diff = 0
    for name in ("bits", "parity_ok", "iterations"):
        g, w = getattr(got, name), getattr(want, name)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        d = int((g.to(torch.int32) - w.to(torch.int32)).abs().max()) if g.numel() else 0
        diff = max(diff, d)
    if diff != 0:
        differing = int((got.bits != want.bits).any(dim=-1).sum())
        raise AssertionError(
            f"kernel differs from plain version: {what}: max abs diff {diff}, "
            f"{differing} codewords with other bits")
    return diff


def compare_case(params, llr, **kw) -> int:
    """Kernel vs plain on the same CUDA tensor (must be equal)."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    got = decoder_cuda.decode(params, llr, **kw)
    torch.cuda.synchronize()
    return require_equal(got, decoder_cuda.decode_plain(params, llr, **kw), kw)


def codeword_llrs(params, d):
    """Full 'cw' LLRs from 'd' LLRs (n, N): 2Z zeros in front, fillers pinned."""
    Z = params.Z_c
    cw = torch.cat([torch.zeros(d.shape[0], 2 * Z, device=d.device), d], dim=-1)
    lo, hi = params.filler_range_d
    cw[:, 2 * Z + lo : 2 * Z + hi] = 1e20
    return cw


class Tally:
    """Cases compared and the worst difference, per kernel variant."""

    def __init__(self):
        self.cases = {}
        self.worst = {}

    def add(self, variant, diff):
        self.cases[variant] = self.cases.get(variant, 0) + 1
        self.worst[variant] = max(self.worst.get(variant, 0), diff)

    @property
    def total(self):
        return sum(self.cases.values())

    @property
    def max_abs_diff(self):
        return max(self.worst.values())


def phase_kernel_vs_plain(dev, tally):
    """Each kernel equals its plain version (tolerance 0, sum-product
    included) at the flagship shape and at small shapes with fillers and Z
    not a multiple of 32: mid-SNR (a mix of sweeps to convergence),
    never-converging and ``iterations=0`` inputs, 'd'/'sys' and 'cw'."""
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    def check(variant, params, llr, **kw):
        tally.add(variant, compare_case(params, llr, **kw))

    ds = dict(channel_format="d", output_format="sys")
    v1 = dict(algorithm="min-sum", **ds)
    shapes = [
        # (params, waterfall dB, low dB, codewords, first-slice variants?,
        #  this slice's variants?)
        (LDPCParams(**FLAGSHIP), -0.75, -4.0, 48, False, False),
        (LDPCParams(BG=2, A=100, G=300, Q_m=2), 1.0, -6.0, 64, True, True),  # Z=20
        (LDPCParams(BG=2, A=400, G=1200, Q_m=2), 0.0, -6.0, 64, True, True),  # Z=52
        (LDPCParams(BG=1, A=44, G=132, Q_m=1), 1.0, -6.0, 64, False, False),  # Z=3
        (LDPCParams(**P3_FIELDS), 0.5, -6.0, 64, False, True),  # Z=208
    ]
    for params, mid_db, low_db, n, first_slice, this_slice in shapes:
        assert params.C == 1
        modulation = "QPSK" if params.Q_m == 2 else "BPSK"
        mid, _ = noisy_d_tilde(params, modulation, mid_db, n, 11, dev)
        low, _ = noisy_d_tilde(params, modulation, low_db, 16, 12, dev)
        mid, low = mid[:, 0], low[:, 0]
        cw = codeword_llrs(params, mid)
        if params.Z_c != 208:
            # around the waterfall: a mix of sweeps to convergence
            check("V1", params, mid, iterations=ITERATIONS, **v1)
            # low SNR: never converges, full budget and the final syndrome pass
            check("V1", params, low, iterations=ITERATIONS, **v1)
            check("V1", params, mid, iterations=0, **v1)
        if first_slice:
            check("V1'", params, cw, iterations=6, layer_order="natural")
            check("V1'", params, cw, iterations=6, algorithm="offset-min-sum")
            check("V4-layered", params, cw, iterations=6, early_termination=False)
            check("V5", params, cw, iterations=6, alpha_schedule=(0.65, 2))
        if not this_slice:
            continue
        fl = dict(schedule="flooding", iterations=P2_ITERATIONS)
        for rule in ("sum-product", "min-sum", "offset-min-sum"):
            tag = {"sum-product": "SP", "min-sum": "NMS", "offset-min-sum": "OMS"}[rule]
            check(f"V3-{tag}", params, mid, algorithm=rule, **fl, **ds)
            check("V4-flooding", params, mid, algorithm=rule,
                  early_termination=False, **fl, **ds)
        check("V3-SP", params, low, algorithm="sum-product", **fl, **ds)
        check("V3-SP", params, mid, algorithm="sum-product", schedule="flooding",
              iterations=0, **ds)
        check("V3-NMS", params, cw, algorithm="min-sum", **fl)
        check("V3-NMS", params, cw, algorithm="min-sum", alpha_schedule=(0.65, 2), **fl)
        sp = dict(algorithm="sum-product", iterations=P2_ITERATIONS)
        check("V2", params, mid, **sp, **ds)
        check("V2", params, low, **sp, **ds)
        check("V2", params, mid, algorithm="sum-product", iterations=0, **ds)
        check("V2", params, cw, early_termination=False, layer_order="natural", **sp)
        bf = dict(message_dtype="bfloat16", algorithm="min-sum")
        check("V6-layered", params, mid, iterations=ITERATIONS, **bf, **ds)
        check("V6-layered", params, low, iterations=ITERATIONS, **bf, **ds)
        check("V6-flooding", params, mid, **bf, **fl, **ds)
        check("V6-flooding", params, cw, message_dtype="bfloat16",
              algorithm="offset-min-sum", early_termination=False, **fl)
    # the largest code: the flooding kernel's shared-memory limit, and
    # bfloat16 messages at the flagship shape
    params = LDPCParams(**FLAGSHIP)
    mid, _ = noisy_d_tilde(params, "QPSK", -1.0, 24, 13, dev)
    check("V3-SP", params, mid[:, 0], algorithm="sum-product",
          schedule="flooding", iterations=P2_ITERATIONS, **ds)
    check("V6-layered", params, mid[:, 0], algorithm="min-sum",
          message_dtype="bfloat16", iterations=ITERATIONS, **ds)


def phase_phi(dev):
    """The kernels' phi device function against the plain ``_phi``: equal
    bits on a log grid and uniform samples over [1e-9, 40]."""
    from ldpc_3gpp_tpu_torch.ops import decoder, decoder_cuda

    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.exp(np.linspace(np.log(1e-9), np.log(40.0), 150_000)),
        rng.uniform(0.0, 40.0, 50_000),
    ]).astype(np.float32)
    x = torch.from_numpy(x).to(dev)
    got = decoder_cuda.phi_on_device(x)
    torch.cuda.synchronize()
    want = decoder._phi(x)
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    rec = dict(values=x.numel(), differing=differ,
               negative_zeros=int(((want == 0) & torch.signbit(want)).sum()))
    if differ:
        raise AssertionError(f"phi on the card differs from the plain version: {rec}")
    return rec


def flagship_config(**kw):
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    params = LDPCParams(**FLAGSHIP)
    assert params.Z_c == 384 and params.C == 1 and params.num_filler == 0
    base = dict(
        params=params, modulation="QPSK", rv_sequence=(0,),
        iterations=ITERATIONS, algorithm="min-sum", early_termination=True,
        backend="auto", schedule="layered",
    )
    return ChainConfig(**{**base, **kw})


def p2_config(**kw):
    """The default decoder: ``algorithm`` and ``schedule`` are left alone."""
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    params = LDPCParams(**P2_FIELDS)
    assert (params.C, params.Z_c, params.K_prime, params.num_filler) == (2, 208, 1957, 123)
    cfg = ChainConfig(params=params, iterations=P2_ITERATIONS, **kw)
    if not kw:
        assert (cfg.algorithm, cfg.schedule, cfg.backend) == (
            "sum-product", "flooding", "auto")
    return cfg


def p3_config(schedule):
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    params = LDPCParams(**P3_FIELDS)
    assert params.C == 1 and params.Z_c == 208
    return ChainConfig(params=params, iterations=8, algorithm="sum-product",
                       schedule=schedule)


def counted_steps(cfg, generator, esn0_db, batch, steps, dev):
    """``run_steps`` with every launch count set to 0 just before and read
    just after: (blocks, errors, iterations, {kernel: launches})."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    torch.cuda.synchronize()
    decoder_cuda.reset_launches()
    out = run_steps(cfg, generator, esn0_db, batch, steps, dev)
    torch.cuda.synchronize()
    return out + (dict(decoder_cuda.LAUNCHES),)


def expect_launches(launches, kernel, count):
    """One launch of ``kernel`` per step and rv stage, none of the other."""
    want = {k: (count if k == kernel else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")


def run_steps(cfg, generator, esn0_db, batch, steps, dev):
    """``steps`` calls of simulate_batch; summed counters as Python ints."""
    from ldpc_3gpp_tpu_torch.models.chain import simulate_batch

    blocks = errors = iters = 0
    for _ in range(steps):
        r = simulate_batch(cfg, generator, esn0_db, batch, device=dev)
        if tuple(r.tb_ok.shape) != (batch,) or tuple(r.iteration_hist.shape) != (
            cfg.iterations + 1,
        ):
            raise AssertionError("simulate_batch returned unexpected shapes")
        if int(r.iteration_hist.sum()) != batch * cfg.params.C:
            raise AssertionError("iteration histogram does not count every block")
        blocks += int(r.blocks)
        errors += int(r.block_errors)
        iters += int(r.iterations)
    return blocks, errors, iters


def phase_chain_gpu_vs_cpu(dev):
    """The whole chain on the card equals the same chain on the CPU (plain
    decoder) on the same bits and noise: the CRC at the flagship length, and
    two small multi-code-block HARQ configurations (layered min-sum; the
    default sum-product flooding decoder) with every counter and flag equal
    (tolerance 0)."""
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig, simulate_given
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    from ldpc_3gpp_tpu_torch.ops.crc import crc_attach, crc_check

    # CRC of the flagship's transport block on the card: equal to the CPU's,
    # and a flipped bit is caught
    rng = np.random.default_rng(4)
    bits = torch.from_numpy(rng.integers(0, 2, (64, FLAGSHIP["A"])).astype(np.int8))
    b_gpu = crc_attach(bits.to(dev), "CRC24A")
    if not torch.equal(b_gpu.cpu(), crc_attach(bits, "CRC24A")):
        raise AssertionError("CRC24A on the card differs from the CPU")
    b_gpu[::2, 100] ^= 1
    want = torch.arange(64) % 2 == 0
    if not torch.equal(crc_check(b_gpu, "CRC24A").cpu(), want):
        raise AssertionError("crc_check on the card missed a flipped bit")

    cases = [
        ("BG1 A=20004 G=60012 C=3 Z=320 QPSK rv (0,2) layered min-sum 8 it",
         ChainConfig(params=LDPCParams(BG=1, A=20004, G=60012, Q_m=2),
                     rv_sequence=(0, 2), iterations=8, algorithm="min-sum",
                     schedule="layered"), 8, -1.75),
        ("BG2 A=3842 G=11526 C=2 Z=208 QPSK rv (0,2) default decoder "
         "(sum-product, flooding) 8 it",
         ChainConfig(params=LDPCParams(**P2_FIELDS), rv_sequence=(0, 2),
                     iterations=P2_ITERATIONS), 8, -1.0),
    ]
    out = []
    for config, cfg, batch, esn0_db in cases:
        params = cfg.params
        rng = np.random.default_rng(5)
        a = torch.from_numpy(rng.integers(0, 2, (batch, params.A)).astype(np.int8))
        noise_var = torch.tensor(10.0 ** (-esn0_db / 10.0), dtype=torch.float32)
        std = math.sqrt(float(noise_var) / 2.0)
        shape = (batch, params.G // 2)
        noise = [
            torch.from_numpy(((rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape)) * std
                              ).astype(np.complex64))
            for _ in cfg.rv_sequence
        ]
        on_cpu = simulate_given(cfg, a, noise, noise_var)
        on_gpu = simulate_given(cfg, a.to(dev), [n.to(dev) for n in noise],
                                noise_var.to(dev))
        for name, c, g in zip(on_cpu._fields, on_cpu, on_gpu):
            if not torch.equal(c, g.cpu()):
                raise AssertionError(
                    f"chain on the card differs from the CPU: {config}: {name}")
        out.append(dict(config=config, blocks=int(on_gpu.blocks),
                        block_errors=int(on_gpu.block_errors),
                        iteration_hist=on_gpu.iteration_hist.tolist()))
    return out


def binomial_gate(name, esn0_db, blocks, errors, golden_errors, n):
    """This run's count against the golden's, both samples of n blocks: the
    difference has variance 2 n p (1-p); the bound is 5 sigma (+1 block)."""
    p = golden_errors / n
    bound = 5.0 * math.sqrt(2.0 * n * p * (1.0 - p)) + 1.0
    rec = dict(path=name, esn0_db=esn0_db, blocks=blocks, block_errors=errors,
               golden_block_errors=golden_errors, bound_blocks=bound)
    if blocks != n or abs(errors - golden_errors) > bound:
        raise AssertionError(f"BLER outside the golden's binomial bound: {rec}")
    return rec


def phase_bler_gate(generator, dev):
    """Block error counts at points of the measured golden waterfalls inside
    a 5-sigma binomial bound: P1 and P4 (bfloat16 messages, held to the same
    bound as float32) against golden/bench_path_bler.json QPSK_R13, P2
    against the headline golden.  Returns the records and P4's launches."""
    with open(os.path.join(ROOT, "golden", "bench_path_bler.json")) as f:
        curve = json.load(f)["QPSK_R13"]
    with open(os.path.join(ROOT, "golden", P2_GOLDEN)) as f:
        headline = json.load(f)
    out = []

    def golden_point(table, esn0_db, n):
        i = table["esn0_db"].index(esn0_db)
        if table["blocks"][i] != n:
            raise AssertionError(f"golden point is not a {n}-block sample")
        return table["block_errors"][i]

    for esn0_db in (-0.75, -1.0):
        blocks, errors, _ = run_steps(flagship_config(), generator, esn0_db, 1024, 2, dev)
        out.append(binomial_gate("P1", esn0_db, blocks, errors,
                                 golden_point(curve, esn0_db, 2048), 2048))
    blocks, errors, _, p4_launches = counted_steps(
        flagship_config(message_dtype="bfloat16"), generator, -0.75, 1024, 2, dev)
    expect_launches(p4_launches, "ldpc_layered", 2)
    out.append(binomial_gate("P4", -0.75, blocks, errors,
                             golden_point(curve, -0.75, 2048), 2048))
    for esn0_db in (0.25, 0.5):
        blocks, errors, _ = run_steps(p2_config(), generator, esn0_db, 1024, 1, dev)
        out.append(binomial_gate("P2", esn0_db, blocks, errors,
                                 golden_point(headline, esn0_db, 1024), 1024))
    return out, p4_launches


def phase_path_3(generator, dev):
    """P3: sum-product at BG2 A=2048 Z=208, 2.0 dB, layered (4 steps) and
    flooding (2 steps) of 1,024 blocks: no block error, and the mean
    iterations per block within 0.15 of golden/bench_sweep.json's."""
    with open(os.path.join(ROOT, "golden", "bench_sweep.json")) as f:
        rows = {r["name"]: r for r in json.load(f)["rows"]}
    out, launches = [], {}
    for schedule, steps in (("layered", 4), ("flooding", 2)):
        row = rows[f"bg2_z208_sumproduct_{schedule}"]
        if (row["esn0_db"], row["iterations_budget"], row["A"]) != (P3_ESN0_DB, 8, 2048):
            raise AssertionError(f"golden row is not P3's configuration: {row}")
        blocks, errors, iters, n = counted_steps(
            p3_config(schedule), generator, P3_ESN0_DB, 1024, steps, dev)
        expect_launches(n, "ldpc_" + schedule, steps)
        launches[schedule] = n["ldpc_" + schedule]
        rec = dict(schedule=schedule, blocks=blocks, block_errors=errors,
                   mean_iterations_per_tb=iters / blocks,
                   golden_mean_iterations_per_tb=row["mean_iterations_per_tb"],
                   tolerance=P3_ITERATION_TOLERANCE, launches=n)
        out.append(rec)
        if errors or abs(rec["mean_iterations_per_tb"]
                         - row["mean_iterations_per_tb"]) > P3_ITERATION_TOLERANCE:
            raise AssertionError(f"P3 outside its gate: {rec}")
    return out, launches


# One step through ``simulate_batch`` for each variant that P1-P4 do not
# run, at its path's full width.  V1' stands for offset-min-sum here; its
# 'cw' formats and row orders are arguments of the kernel wrapper alone.
VARIANT_STEPS = {
    "V1'": ("ldpc_layered", lambda: flagship_config(algorithm="offset-min-sum")),
    "V4-layered": ("ldpc_layered", lambda: flagship_config(early_termination=False)),
    "V5": ("ldpc_layered", lambda: flagship_config(alpha_schedule=(0.65, 2))),
    "V3-NMS": ("ldpc_flooding", lambda: p2_config(algorithm="min-sum")),
    "V3-OMS": ("ldpc_flooding", lambda: p2_config(algorithm="offset-min-sum")),
    "V4-flooding": ("ldpc_flooding", lambda: p2_config(early_termination=False)),
    "V6-flooding": ("ldpc_flooding", lambda: p2_config(
        algorithm="min-sum", message_dtype="bfloat16")),
}


def phase_variant_steps(generator, dev):
    """Launches per variant in one 256-block step at 1.0 dB each."""
    out = {}
    for variant, (kernel, make) in VARIANT_STEPS.items():
        blocks, errors, _, n = counted_steps(make(), generator, 1.0, 256, 1, dev)
        expect_launches(n, kernel, 1)
        out[variant] = dict(launches=n[kernel], blocks=blocks, block_errors=errors)
    return out


def kernel_bound(params, res, budget, n_in_cols, out_cols, *, schedule="layered",
                 algorithm="min-sum", early_termination=True, message_bytes=4):
    """Least time (ms) the card could take for this run's decodes.

    Bytes: each input LLR read once, each output bit and flag written once.
    Operations: per edge and lane, OPS_PER_EDGE_LANE (min-sum family) or
    OPS_PER_EDGE_LANE_SUM_PRODUCT for every update sweep this run's data
    needed, and one for every syndrome pass.  Layered with early
    termination: a codeword that passed at sweep ``it`` ran ``it + 1``
    update sweeps, one that never passed the budget and one syndrome pass.
    Flooding with early termination: ``it`` update sweeps and ``it + 1``
    syndrome passes (the budget and budget + 1 if it never passed).  A run
    to budget: the budget and one syndrome pass."""
    n = res.iterations.numel()
    Z, E = params.Z_c, len(params.edges[0])
    used = res.iterations.to(torch.int64).reshape(-1)
    passed = res.parity_ok.reshape(-1)
    full = torch.full_like(used, budget)
    if not early_termination:
        updates, syndromes = full, torch.ones_like(used)
    elif schedule == "layered":
        early = passed & (used < budget)
        updates = torch.where(early, used + 1, full)
        syndromes = (~early).to(torch.int64)
    else:
        updates, syndromes = used, used + 1
    total_updates, total_syndromes = int(updates.sum()), int(syndromes.sum())
    per_update = (OPS_PER_EDGE_LANE_SUM_PRODUCT if algorithm == "sum-product"
                  else OPS_PER_EDGE_LANE)
    nbytes = n * (n_in_cols * Z * 4 + out_cols * Z + 8)
    ops = E * Z * (per_update * total_updates
                   + OPS_PER_EDGE_LANE_SYNDROME * total_syndromes)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    # the scratch traffic of this design (one message write per update
    # sweep, one read per update sweep after the first), for PERF.md; not
    # part of the bound
    scratch = E * Z * message_bytes * int((2 * updates - (updates > 0).to(torch.int64)).sum())
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops,
        mean_sweeps=total_updates / n,
        scratch_traffic_ms=scratch / PEAK_BYTES_PER_S * 1e3,
    )


def measure_variant(params, llr, reps, **kw):
    """One kernel variant at its path's shape: time by CUDA events, the
    plain version's time (one run), equality with it, and the bound."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    res = decoder_cuda.decode(params, llr, **kw)
    ms = time_ms(lambda: decoder_cuda.decode(params, llr, **kw), reps=reps)
    holder = {}

    def plain():
        holder["res"] = decoder_cuda.decode_plain(params, llr, **kw)

    plain_ms = time_ms(plain, reps=1, warmup=0)
    diff = require_equal(res, holder["res"], kw)
    nc = params.num_cols
    bound = kernel_bound(
        params, res, kw["iterations"],
        nc - 2 if kw.get("channel_format") == "d" else nc,
        params.num_sys_cols if kw.get("output_format") == "sys" else nc,
        schedule=kw.get("schedule", "layered"),
        algorithm=kw.get("algorithm", "min-sum"),
        early_termination=kw.get("early_termination", True),
        message_bytes=2 if kw.get("message_dtype") == "bfloat16" else 4,
    )
    n = res.iterations.numel()
    return dict(ms=ms, us_per_codeword=ms * 1e3 / n, plain_ms=plain_ms,
                max_abs_diff=diff, codewords=n, **bound)


def profile_steps(step, n, step_ms):
    """Device time per step by kernel name, from ``torch.profiler`` over
    ``n`` steps, and its share of the unprofiled step time ``step_ms``.
    Device numbers are None where the profiler shows no device time (then
    they are not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side operator rows repeat their kernels' time
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, ev.count / n, ev.key))
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        return {"steps": n, "device_busy_ms_per_step": None,
                "device_busy_share": None, "top": None}
    rows.sort(reverse=True)
    return {
        "steps": n, "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / step_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "kernels_per_step": sum(r[1] for r in rows),
        "top": [{"name": k[:60], "ms_per_step": ms, "per_step": c}
                for ms, c, k in rows[:6]],
    }


def step_times(cfg, generator, esn0_db, dev):
    """Whole-step time (host clock around work that ends in a synchronise),
    stage times (CUDA events, each stage alone) and the profiler's device
    busy share for ``simulate_batch`` of MAIN_BATCH blocks."""
    from ldpc_3gpp_tpu_torch.models.chain import simulate_batch
    from ldpc_3gpp_tpu_torch.models.decoder import (
        decode_transport_block_d, split_rate_matched_symbols,
    )
    from ldpc_3gpp_tpu_torch.models.encoder import encode_to_symbols
    from ldpc_3gpp_tpu_torch.ops.channel import complex_noise, esn0_to_variance

    p = cfg.params

    def step():
        return simulate_batch(cfg, generator, esn0_db, MAIN_BATCH, device=dev)

    step()
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        r = step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    if int(r.blocks) != MAIN_BATCH:
        raise AssertionError("timed step did not simulate the whole batch")

    noise_var = esn0_to_variance(esn0_db, device=dev)
    a = torch.randint(0, 2, (MAIN_BATCH, p.A), generator=generator,
                      device=dev, dtype=torch.int8)
    tx = encode_to_symbols(p, a, "QPSK")
    rx = tx + complex_noise(generator, tx.shape, noise_var, dev)
    d_tilde = split_rate_matched_symbols(p, rx, "QPSK", noise_var)
    dkw = dict(iterations=cfg.iterations, algorithm=cfg.algorithm,
               schedule=cfg.schedule, backend=cfg.backend)
    stages = {
        "encode_to_symbols": time_ms(lambda: encode_to_symbols(p, a, "QPSK"), 5),
        "draw_bits_and_noise": time_ms(lambda: (
            torch.randint(0, 2, (MAIN_BATCH, p.A), generator=generator,
                          device=dev, dtype=torch.int8),
            complex_noise(generator, tx.shape, noise_var, dev)), 5),
        "split_rate_matched_symbols": time_ms(
            lambda: split_rate_matched_symbols(p, rx, "QPSK", noise_var), 5),
        "decode_transport_block_d": time_ms(
            lambda: decode_transport_block_d(p, d_tilde, **dkw), 5),
    }
    return {
        "batch": MAIN_BATCH, "esn0_db": esn0_db, "step_ms": step_s * 1e3,
        "transport_blocks_per_s": MAIN_BATCH / step_s,
        "decoded_info_mbit_per_s": MAIN_BATCH * p.A / step_s / 1e6,
        "stage_ms": stages, "profile": profile_steps(step, 3, step_s * 1e3),
    }


def phase_times(generator, dev, card):
    """Every kernel variant at its path's shape, and P1's and P2's steps.
    Returns {variant: measurements}."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    ds = dict(channel_format="d", output_format="sys")
    out = {}

    # the flagship shape: the tensor P1 hands the kernel, (1024, 1, N) at 1.0 dB
    p1 = LDPCParams(**FLAGSHIP)
    d1, _ = noisy_d_tilde(p1, "QPSK", MAIN_ESN0_DB, MAIN_BATCH, 21, dev)
    v1 = dict(iterations=ITERATIONS, algorithm="min-sum", **ds)
    out["V1"] = measure_variant(p1, d1, 20, **v1)
    # the same codewords four times over: more waves of blocks per launch
    d4 = d1.repeat(4, 1, 1)
    ms4 = time_ms(lambda: decoder_cuda.decode(p1, d4, **v1), reps=5)
    out["V1"]["us_per_codeword_at_4x_batch"] = ms4 * 1e3 / (4 * MAIN_BATCH)
    del d4
    cw1 = codeword_llrs(p1, d1[:, 0])
    out["V1'"] = measure_variant(p1, cw1, 10, iterations=ITERATIONS,
                                 algorithm="min-sum", layer_order="natural")
    out["V4-layered"] = measure_variant(p1, d1, 10, early_termination=False, **v1)
    out["V5"] = measure_variant(p1, d1, 10, alpha_schedule=(0.65, 2), **v1)
    out["V6-layered"] = measure_variant(p1, d1, 10, message_dtype="bfloat16", **v1)
    del d1, cw1

    # P2's shape: (1024, 2, N) at 1.0 dB, 2,048 codewords per launch
    p2 = LDPCParams(**P2_FIELDS)
    d2, _ = noisy_d_tilde(p2, "QPSK", MAIN_ESN0_DB, MAIN_BATCH, 22, dev)
    fl = dict(schedule="flooding", iterations=P2_ITERATIONS, **ds)
    out["V3-SP"] = measure_variant(p2, d2, 10, algorithm="sum-product", **fl)
    out["V3-NMS"] = measure_variant(p2, d2, 10, algorithm="min-sum", **fl)
    out["V3-OMS"] = measure_variant(p2, d2, 10, algorithm="offset-min-sum", **fl)
    out["V4-flooding"] = measure_variant(
        p2, d2, 10, algorithm="sum-product", early_termination=False, **fl)
    out["V6-flooding"] = measure_variant(
        p2, d2, 10, algorithm="min-sum", message_dtype="bfloat16", **fl)
    del d2

    # P3's shape: (1024, 1, N) at 2.0 dB
    p3 = LDPCParams(**P3_FIELDS)
    d3, _ = noisy_d_tilde(p3, "QPSK", P3_ESN0_DB, MAIN_BATCH, 23, dev)
    out["V2"] = measure_variant(p3, d3, 10, algorithm="sum-product", iterations=8, **ds)
    del d3

    emit({"times": {
        "card": card,
        "kernels": {v: {k: m[k] for k in (
            "ms", "us_per_codeword", "plain_ms", "bound_ms", "bound_by",
            "scratch_traffic_ms", "mean_sweeps", "codewords")}
            for v, m in out.items()},
        "kernel_us_per_codeword_at_4x_batch": out["V1"]["us_per_codeword_at_4x_batch"],
        "P1": step_times(flagship_config(), generator, MAIN_ESN0_DB, dev),
        "P2": step_times(p2_config(), generator, MAIN_ESN0_DB, dev),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }})
    return out


# (variant, kernel source, lines of the TPU kernel it replaces)
VARIANTS = [
    ("V1", LAYERED_SOURCE, TPU_KERNEL),
    ("V1'", LAYERED_SOURCE, TPU_KERNEL + " (:213-214, 243-261, 358-359)"),
    ("V4-layered", LAYERED_SOURCE, TPU_KERNEL + " (:494-500, 549-573)"),
    ("V5", LAYERED_SOURCE, TPU_KERNEL + " (:428-440)"),
    ("V2", LAYERED_SOURCE, TPU_KERNEL + " (:228-239)"),
    ("V6-layered", LAYERED_SOURCE, TPU_KERNEL + " (:492, 633-635)"),
    ("V3-SP", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V3-NMS", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V3-OMS", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V4-flooding", FLOODING_SOURCE, TPU_KERNEL + " (:494-500, 549-573)"),
    ("V6-flooding", FLOODING_SOURCE, TPU_KERNEL + " (:480-484, 633-635)"),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    from ldpc_3gpp_tpu_torch import kernels_build
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    if "jax" in sys.modules or "ldpc_3gpp_tpu" in sys.modules:
        raise AssertionError("the port pulled in JAX or the JAX package")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = kernels_build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln for n in libs for ln in kernels_build.build_log(n).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": build_s, "kernels": sorted(libs),
          "ptxas": ptxas})

    tally = Tally()
    phase_kernel_vs_plain(dev, tally)
    emit({"phase": "kernel_vs_plain", "cases": tally.total,
          "max_abs_diff": tally.max_abs_diff, "tolerance": 0,
          "cases_by_variant": tally.cases})

    emit({"phase": "phi", **phase_phi(dev)})

    launches = {}  # variant -> launches on the path that runs it
    generator = make_generator(0, dev)
    cfg = flagship_config()
    blocks, errors, iters, n = counted_steps(
        cfg, generator, MAIN_ESN0_DB, MAIN_BATCH, MAIN_STEPS, dev)
    emit({"phase": "main_path", "config": "BG1 A=8424 G=25272 Z=384 QPSK "
          "layered min-sum 12 it early termination", "esn0_db": MAIN_ESN0_DB,
          "batch": MAIN_BATCH, "steps": MAIN_STEPS, "blocks": blocks,
          "block_errors": errors, "mean_iterations_per_tb": iters / blocks,
          "launches": n})
    expect_launches(n, "ldpc_layered", MAIN_STEPS * len(cfg.rv_sequence))
    launches["V1"] = n["ldpc_layered"]
    if blocks != MAIN_BATCH * MAIN_STEPS or errors > 2:
        raise AssertionError(f"main path: {errors} block errors in {blocks} blocks")

    blocks, errors, iters, n = counted_steps(
        p2_config(), generator, MAIN_ESN0_DB, MAIN_BATCH, MAIN_STEPS, dev)
    emit({"phase": "main_path_2", "config": "BG2 A=3842 G=11526 C=2 Z=208 QPSK "
          "default decoder (sum-product, flooding) 8 it early termination",
          "esn0_db": MAIN_ESN0_DB, "batch": MAIN_BATCH, "steps": MAIN_STEPS,
          "codewords_per_launch": MAIN_BATCH * 2, "blocks": blocks,
          "block_errors": errors, "golden_bler": 107 / 24576,
          "max_block_errors": P2_MAX_ERRORS,
          "mean_iterations_per_tb": iters / blocks, "launches": n})
    expect_launches(n, "ldpc_flooding", MAIN_STEPS)
    launches["V3-SP"] = n["ldpc_flooding"]
    if blocks != MAIN_BATCH * MAIN_STEPS or errors > P2_MAX_ERRORS:
        raise AssertionError(f"main path 2: {errors} block errors in {blocks} blocks")

    emit({"phase": "chain_gpu_vs_cpu", "cases": phase_chain_gpu_vs_cpu(dev)})

    points, p4_launches = phase_bler_gate(generator, dev)
    emit({"phase": "bler_gate", "points": points})
    launches["V6-layered"] = p4_launches["ldpc_layered"]

    p3, p3_launches = phase_path_3(generator, dev)
    emit({"phase": "path_3", "config": "BG2 A=2048 G=6144 Z=208 QPSK "
          "sum-product 8 it early termination", "esn0_db": P3_ESN0_DB,
          "schedules": p3})
    launches["V2"] = p3_launches["layered"]

    steps = phase_variant_steps(generator, dev)
    emit({"phase": "variant_steps", "variants": steps})
    launches.update({v: rec["launches"] for v, rec in steps.items()})

    times = phase_times(generator, dev, card)

    kernels = []
    for variant, source, replaces in VARIANTS:
        m = times[variant]
        if launches[variant] < 1:
            raise AssertionError(f"{variant} was launched on no path")
        diff = max(tally.worst[variant], m["max_abs_diff"])
        kernels.append({
            "name": f"{os.path.splitext(os.path.basename(source))[0]}/{variant}",
            "route": "cuda", "source": source, "replaces": replaces,
            "variant": variant, "cases": tally.cases[variant] + 1,
            "launches": launches[variant], "max_abs_err": diff,
            "max_abs_diff": diff, "tolerance": 0,
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,
            "bytes_ms": m["bytes_ms"], "operations_ms": m["operations_ms"],
            "scratch_traffic_ms": m["scratch_traffic_ms"],
            "mean_sweeps": m["mean_sweeps"], "codewords": m["codewords"],
            "card": card,
        })
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
