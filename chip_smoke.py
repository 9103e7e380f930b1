#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port still starts on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernel from the sources in the checkout, holds it against
its plain PyTorch version on the card (min-sum family: exact equality,
tolerance 0), drives the port's main path (``simulate_batch`` at BG1 A=8424
Z=384 QPSK, layered normalized min-sum, 12 iterations, early termination)
through the kernel, gates the block error rate against the measured golden
waterfall, and times the kernel and the step with CUDA events.

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

FLAGSHIP = dict(BG=1, A=8424, G=25272, Q_m=2)
ITERATIONS = 12
MAIN_BATCH = 1024
MAIN_STEPS = 4
MAIN_ESN0_DB = 1.0


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


def compare_case(params, llr, **kw) -> int:
    """Kernel vs plain on the same CUDA tensor; returns the max abs diff
    over bits, parity flags and iteration counts (must be 0)."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    got = decoder_cuda.decode(params, llr, **kw)
    torch.cuda.synchronize()
    want = decoder_cuda.decode_plain(params, llr, **kw)
    diff = 0
    for name in ("bits", "parity_ok", "iterations"):
        g, w = getattr(got, name), getattr(want, name)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        d = int((g.to(torch.int32) - w.to(torch.int32)).abs().max()) if g.numel() else 0
        diff = max(diff, d)
    if diff != 0:
        raise AssertionError(f"kernel differs from plain version: {kw} diff {diff}")
    return diff


def phase_kernel_vs_plain(dev):
    """The kernel equals its plain version at the flagship shape and at three
    small shapes with fillers and Z not a multiple of 32."""
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    cases = 0
    worst = 0
    v1 = dict(algorithm="min-sum", channel_format="d", output_format="sys")
    shapes = [
        # (params, waterfall dB, low dB, codewords, extra variants?)
        (LDPCParams(**FLAGSHIP), -0.75, -4.0, 48, False),
        (LDPCParams(BG=2, A=100, G=300, Q_m=2), 1.0, -6.0, 64, True),  # Z=20
        (LDPCParams(BG=2, A=400, G=1200, Q_m=2), 0.0, -6.0, 64, True),  # Z=52
        (LDPCParams(BG=1, A=44, G=132, Q_m=1), 1.0, -6.0, 64, False),  # Z=3
    ]
    for params, mid_db, low_db, n, variants in shapes:
        assert params.C == 1
        modulation = "QPSK" if params.Q_m == 2 else "BPSK"
        mid, _ = noisy_d_tilde(params, modulation, mid_db, n, 11, dev)
        low, _ = noisy_d_tilde(params, modulation, low_db, 16, 12, dev)
        mid, low = mid[:, 0], low[:, 0]
        # around the waterfall: a mix of sweeps to convergence
        worst = max(worst, compare_case(params, mid, iterations=ITERATIONS, **v1))
        # low SNR: never converges, full budget and the final syndrome pass
        worst = max(worst, compare_case(params, low, iterations=ITERATIONS, **v1))
        worst = max(worst, compare_case(params, mid, iterations=0, **v1))
        cases += 3
        if variants:
            Z = params.Z_c
            cw = torch.cat([torch.zeros(n, 2 * Z, device=dev), mid], dim=-1)
            lo, hi = params.filler_range_d
            cw[:, 2 * Z + lo : 2 * Z + hi] = 1e20
            for kw in (
                dict(layer_order="natural"),
                dict(algorithm="offset-min-sum"),
                dict(early_termination=False),
                dict(alpha_schedule=(0.65, 2)),
            ):
                worst = max(worst, compare_case(params, cw, iterations=6, **kw))
                cases += 1
    return cases, worst


def flagship_config():
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    params = LDPCParams(**FLAGSHIP)
    assert params.Z_c == 384 and params.C == 1 and params.num_filler == 0
    return ChainConfig(
        params=params, modulation="QPSK", rv_sequence=(0,),
        iterations=ITERATIONS, algorithm="min-sum", early_termination=True,
        backend="auto", schedule="layered",
    )


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
    a small multi-code-block HARQ configuration with every counter and flag
    equal (tolerance 0)."""
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

    params = LDPCParams(BG=1, A=20004, G=60012, Q_m=2)  # C=3, Z=320
    cfg = ChainConfig(params=params, modulation="QPSK", rv_sequence=(0, 2),
                      iterations=8, algorithm="min-sum", schedule="layered")
    batch, esn0_db = 8, -1.75
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
            raise AssertionError(f"chain on the card differs from the CPU: {name}")
    return dict(config="BG1 A=20004 G=60012 C=3 Z=320 QPSK rv (0,2) 8 it",
                blocks=int(on_gpu.blocks), block_errors=int(on_gpu.block_errors),
                iteration_hist=on_gpu.iteration_hist.tolist())


def phase_bler_gate(cfg, generator, dev):
    """Block error counts at two points of the measured golden waterfall
    (golden/bench_path_bler.json, QPSK_R13) inside a 5-sigma binomial bound.

    The golden count and this run's count are two samples of n blocks each,
    so their difference has variance 2 n p (1-p); the bound is 5 sigma of
    that (+1 block), with p the golden rate."""
    with open(os.path.join(ROOT, "golden", "bench_path_bler.json")) as f:
        curve = json.load(f)["QPSK_R13"]
    out = []
    for esn0_db in (-0.75, -1.0):
        i = curve["esn0_db"].index(esn0_db)
        n = curve["blocks"][i]
        golden_errors = curve["block_errors"][i]
        if n != 2048:
            raise AssertionError("golden point is not a 2048-block sample")
        p = golden_errors / n
        blocks, errors, _ = run_steps(cfg, generator, esn0_db, 1024, 2, dev)
        bound = 5.0 * math.sqrt(2.0 * n * p * (1.0 - p)) + 1.0
        rec = dict(esn0_db=esn0_db, blocks=blocks, block_errors=errors,
                   golden_block_errors=golden_errors, bound_blocks=bound)
        out.append(rec)
        if blocks != n or abs(errors - golden_errors) > bound:
            raise AssertionError(f"BLER outside the golden's binomial bound: {rec}")
    return out


def kernel_bound(params, iterations_used, parity_ok, budget):
    """Least time (ms) the card could take for this run's decodes.

    Bytes: each input LLR read once, each output bit and flag written once.
    Operations: OPS_PER_EDGE_LANE per edge and lane for every update sweep
    this run's data needed (a codeword that passed at sweep ``it`` ran
    ``it + 1`` sweeps; one that never passed ran the budget and one syndrome
    pass)."""
    n = iterations_used.numel()
    Z, E = params.Z_c, len(params.edges[0])
    used = iterations_used.to(torch.int64)
    passed_early = parity_ok & (used < budget)
    sweeps = torch.where(passed_early, used + 1, torch.full_like(used, budget))
    total_sweeps = int(sweeps.sum())
    syndrome_passes = int((~passed_early).sum())
    nbytes = n * ((params.num_cols - 2) * Z * 4 + params.K + 8)
    ops = E * Z * (OPS_PER_EDGE_LANE * total_sweeps
                   + OPS_PER_EDGE_LANE_SYNDROME * syndrome_passes)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    # the scratch traffic of this design (one message write per sweep, one
    # read per sweep after the first), for PERF.md; not part of the bound
    scratch = E * Z * 4 * (2 * total_sweeps - n)
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops,
        mean_sweeps=total_sweeps / n,
        scratch_traffic_ms=scratch / PEAK_BYTES_PER_S * 1e3,
    )


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


def phase_times(cfg, generator, dev, card):
    """Kernel, plain version and whole-step times at the flagship point."""
    from ldpc_3gpp_tpu_torch.models.chain import simulate_batch
    from ldpc_3gpp_tpu_torch.models.decoder import (
        decode_transport_block_d, split_rate_matched_symbols,
    )
    from ldpc_3gpp_tpu_torch.models.encoder import encode_to_symbols
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.ops.channel import complex_noise, esn0_to_variance

    p = cfg.params
    # the tensor the main path hands the kernel: (batch, C, N) at 1.0 dB
    d_tilde, _ = noisy_d_tilde(p, "QPSK", MAIN_ESN0_DB, MAIN_BATCH, 21, dev)
    kw = dict(iterations=ITERATIONS, algorithm="min-sum", alpha=cfg.alpha,
              channel_format="d", output_format="sys")
    res = decoder_cuda.decode(p, d_tilde, **kw)
    bound = kernel_bound(p, res.iterations, res.parity_ok, ITERATIONS)
    ms = time_ms(lambda: decoder_cuda.decode(p, d_tilde, **kw), reps=20)
    plain_ms = time_ms(lambda: decoder_cuda.decode_plain(p, d_tilde, **kw),
                       reps=1, warmup=1)
    diff = compare_case(p, d_tilde[:, 0], **kw)
    # the same codewords four times over: more waves of blocks per launch
    d_tilde4 = d_tilde.repeat(4, 1, 1)
    ms4 = time_ms(lambda: decoder_cuda.decode(p, d_tilde4, **kw), reps=5)
    del d_tilde4

    # whole step: host clock around work that ends in a synchronise
    def step():
        return simulate_batch(cfg, generator, MAIN_ESN0_DB, MAIN_BATCH, device=dev)

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

    # where the step's device time goes, stage by stage (CUDA events)
    noise_var = esn0_to_variance(MAIN_ESN0_DB, device=dev)
    a = torch.randint(0, 2, (MAIN_BATCH, p.A), generator=generator,
                      device=dev, dtype=torch.int8)
    tx = encode_to_symbols(p, a, "QPSK")
    rx = tx + complex_noise(generator, tx.shape, noise_var, dev)
    dkw = dict(iterations=ITERATIONS, algorithm="min-sum", schedule="layered",
               backend="auto")
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
    profile = profile_steps(step, 3, step_s * 1e3)
    emit({"times": {
        "card": card, "batch": MAIN_BATCH, "esn0_db": MAIN_ESN0_DB,
        "kernel_ms": ms, "kernel_us_per_codeword": ms * 1e3 / MAIN_BATCH,
        "kernel_us_per_codeword_at_4x_batch": ms4 * 1e3 / (4 * MAIN_BATCH),
        "plain_ms": plain_ms, "mean_sweeps": bound["mean_sweeps"],
        "step_ms": step_s * 1e3,
        "transport_blocks_per_s": MAIN_BATCH / step_s,
        "decoded_info_mbit_per_s": MAIN_BATCH * p.A / step_s / 1e6,
        "stage_ms": stages, "profile": profile,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }})
    return ms, plain_ms, bound, diff


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    from ldpc_3gpp_tpu_torch import kernels_build
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
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
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "kernels": sorted(libs),
          "ptxas": ptxas})

    cases, worst = phase_kernel_vs_plain(dev)
    emit({"phase": "kernel_vs_plain", "cases": cases, "max_abs_diff": worst})

    cfg = flagship_config()
    generator = make_generator(0, dev)
    decoder_cuda.LAUNCHES = 0
    blocks, errors, iters = run_steps(
        cfg, generator, MAIN_ESN0_DB, MAIN_BATCH, MAIN_STEPS, dev)
    torch.cuda.synchronize()
    launches = decoder_cuda.LAUNCHES
    emit({"phase": "main_path", "config": "BG1 A=8424 G=25272 Z=384 QPSK "
          "layered min-sum 12 it early termination", "esn0_db": MAIN_ESN0_DB,
          "batch": MAIN_BATCH, "steps": MAIN_STEPS, "blocks": blocks,
          "block_errors": errors, "mean_iterations_per_tb": iters / blocks,
          "launches": launches})
    if launches != MAIN_STEPS * len(cfg.rv_sequence):
        raise AssertionError(f"expected one launch per step and rv stage, got {launches}")
    if blocks != MAIN_BATCH * MAIN_STEPS or errors > 2:
        raise AssertionError(f"main path: {errors} block errors in {blocks} blocks")

    emit({"phase": "chain_gpu_vs_cpu", **phase_chain_gpu_vs_cpu(dev)})

    emit({"phase": "bler_gate", "points": phase_bler_gate(cfg, generator, dev)})

    ms, plain_ms, bound, diff = phase_times(cfg, generator, dev, card)

    print(card, flush=True)
    emit({"kernels": [{
        "name": "ldpc_layered", "route": "cuda",
        "source": "ldpc_3gpp_tpu_torch/csrc/ldpc_layered.cu",
        "replaces": "ldpc_3gpp_tpu/ops/decoder_pallas.py:264",
        "variant": "V1", "cases": cases + 1,
        "launches": launches, "max_abs_err": max(worst, diff),
        "max_abs_diff": max(worst, diff), "tolerance": 0,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
        "bytes_ms": bound["bytes_ms"], "operations_ms": bound["operations_ms"],
        "scratch_traffic_ms": bound["scratch_traffic_ms"],
        "mean_sweeps": bound["mean_sweeps"], "codewords": MAIN_BATCH,
        "card": card,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
