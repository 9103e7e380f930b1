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
- one step each for the variants that no path above runs;
- P5: the sweeps, ``snr_vs_a`` with the reference's defaults (BG1
  R=1/3 QPSK, sum-product flooding, 50 iterations, A = 1000..8000) and
  ``bler_vs_snr`` at BG2 A=100 R=1/2 (min-sum flooding, Z=20), the latter
  once more with an explicit four codewords per block (same points required),
  ``MonteCarlo`` with 64QAM, and every lifting size of both base graphs with
  16QAM/64QAM.

Then the user's entry points, each path with the counts set to 0 before
it and read after: the 'mxu' encoder equal to the roll/XOR encoder at every
small lifting size and the flagship, and ``encode_to_symbols`` timed with
both; the segment-op reference decoder on the card equal to itself on the
CPU and to the flooding kernel; the console commands in-process (the sweeps,
the testbench's encode and ``--decode`` trials against the C++ oracle, which
must launch the flooding kernels, the overlay plot) and an API round trip
equal to the same objects on the CPU.

Then the multi-process path (``distributed``): ``MonteCarlo`` at P1 in a
world of one under NCCL equal to the same seed without a group, two ranks on
the one card under gloo (started through ``parallel/launcher.py``) equal to
the sum of the single-process runs of their two streams, and
``dryrun_multichip(2)`` and ``entry()`` through the kernels; and the campaign
tools (``campaign``): the bulk tool at the four bulk goldens'
configurations, each BLER inside the two-sample bound of its golden and
its TB/s read from a window of at least three seconds, and two
entries of the campaign matrix with their calibrated Es/N0 beside the
golden's.  The lifting-size phase runs through the lifting-sweep tool.  Then
the golden pipeline (``goldens``): density evolution against the published
(3,6) threshold and the golden BG1 thresholds, BLER points of the headline,
config2 (HARQ IR) and demod protocols inside their two-sample bounds, one
surface row through the ``surface`` stage within 0.15 dB of its golden and
above the normal-approximation bound, config #1's stage through the plain
'fast' decoder and through the kernel equal, and whether ``golden_torch/``'s
stamps are current.  Then the benchmark (``bench``): the headline of the
port's ``bench.py`` and every row of its sweep at a cut protocol (at most 2
block errors at the headline, both scalar baseline rates; each row's mean
iterations within 15 % of both ``bench_sweep`` goldens and its BLER inside
the two-sample bound of the JAX row), the roofline's three rows
(``tools/roofline.py``, which holds ``kernel_bound`` and ``measure_variant``
for the ``kernels`` line) and ``tools/profile_sim.py``'s busy and idle share
at P1, each part with its launches counted.  Then the experiment tools
(``experiments``): the alpha scan, the ``alpha_schedule`` screen with the
baseline's gate at -0.75 dB inside the two-sample bound of
``golden/bench_path_bler.json``, float32 against bfloat16 messages and the
launch-shape scan at cut sizes, each tool with its launches counted and one
of its rows equal to the plain version, every launch shape equal to the
rules' launch.
Then the benchmark's cells (``benchmark``): each cell of ``BENCHMARK.json``
once through ``benchmark_torch/run.py`` at a short cut made from its traffic
alone (``benchmark_cut``), with its launches
counted, every metric measured and every check of the cell true.

It holds the packed kernels (several small-Z codewords per block) equal to the
one-codeword kernels and the plain versions, the op-rate microbenchmark equal
to its plain version, gates block error rates, required Es/N0 and mean
iteration counts against the measured goldens, and times every kernel variant
and the steps with CUDA events.

Every phase raises on failure (non-zero exit, no ``ok`` line).  One JSON
object per line; the line before the last holds ``{"kernels": [...]}`` and
the last is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ldpc_3gpp_tpu_torch.tools.profile_sim import profile_steps
from ldpc_3gpp_tpu_torch.tools.roofline import (
    PEAK_BYTES_PER_S, PEAK_OPS_PER_S, measure_variant, measured_rate, noisy_d_tilde,
    rate_shape, require_equal,
)
from ldpc_3gpp_tpu_torch.utils.profiling import time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = dict(BG=1, A=8424, G=25272, Q_m=2)
ITERATIONS = 12
MAIN_BATCH = 1024
MAIN_STEPS = 2
MAIN_ESN0_DB = 1.0
# a step of the flagship_headline benchmark cell: the launch its kernels-line
# row V1-flagship is timed at and held to the plain version
FLAGSHIP_CELL_BATCH = 32768

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
OP_RATES_SOURCE = "ldpc_3gpp_tpu_torch/csrc/op_rates.cu"
TPU_KERNEL = "ldpc_3gpp_tpu/ops/decoder_pallas.py:264"
TPU_PACKING = TPU_KERNEL + " (:99-116, 338-341, 406-413, 782-806, 821-830)"
TPU_OP_RATES = "tools/vpu_ceiling.py:35"

# P5: the sweep path.  BASELINE config #1 (BG2 A=100 R=1/2 QPSK, Z=20,
# flooding normalized min-sum, 50 iterations) and the reference's snr_vs_a
# defaults; goldens measured with the JAX package.
CONFIG1_FIELDS = dict(BG=2, A=100, G=200, Q_m=2)
CONFIG1_GOLDEN = "BLER_vs_SNR_BG2_A100_R12_QPSK_50it_minsum.json"
CONFIG1_BATCH = 2048
# a step of the config1_bg2_a100_b524288 benchmark cell: the launch its
# kernels-line row V3-NMS-config1 is timed at and held to the plain version
CONFIG1_CELL_BATCH = 524288
# The automatic rule packs no call of either sweep (both decode by flooding,
# which never packs), so the packed kernels run on this path by the explicit
# knob: config #1 again with ``codewords_per_block=CONFIG1_PACK`` (the packed
# flooding kernel; a layered launch of it runs four warps of the warp form),
# which must change no point.
CONFIG1_PACK = 4
SNR_VS_A_GOLDEN = "SNR_vs_A_BG1_R13_QPSK_50it_sumproduct.json"
# Required Es/N0 is interpolated between two points of 100 block errors each
# on a 0.1 dB grid, so a point of the golden itself carries about +-0.03 dB of
# sampling noise, and so does this run's; the waterfall's slope turns one
# grid step of disagreement about where BLER crosses 1e-2 into less than
# 0.1 dB.  0.15 dB holds both and is a sixth of the spread over A (0.58 dB).
SNR_VS_A_TOLERANCE_DB = 0.15
PACKED_ZS = (2, 3, 5, 8, 13, 20, 32, 36, 48, 96, 144, 208)
# The one-codeword flooding kernel at the edges of its layouts (one block
# per codeword up to BG2 Z=224 and BG1 Z=144, a cluster of 2 or 3 blocks
# above), at Z = 2 and at Z = 384 of both base graphs: (base graph, Z,
# message dtype of the min-sum family).  LAYOUT_EDGE_CODEWORDS per case: two
# per SM.
LAYOUT_EDGES = (
    (2, 224, "float32"), (2, 240, "float32"), (1, 144, "float32"), (1, 160, "float32"),
    (2, 352, "bfloat16"), (2, 384, "bfloat16"), (1, 240, "bfloat16"), (1, 256, "bfloat16"),
    (1, 2, "float32"), (1, 384, "float32"), (2, 384, "float32"),
)
LAYOUT_EDGE_CODEWORDS = 264
# snr_vs_a's launches at both ends of its range (BG1 R=1/3 QPSK, 256
# codewords per call, 50 iterations), near each A's required Es/N0 (golden:
# -1.610 dB at A=8000, -1.015 dB at A=1000): row name -> (fields, Es/N0).
SWEEP_ROWS = {
    "V3-SP-sweep": (dict(BG=1, A=8000, G=24000, Q_m=2), -1.6),
    "V3-SP-sweep-A1000": (dict(BG=1, A=1000, G=3000, Q_m=2), -1.0),
}
SWEEP_BATCH = 256
SWEEP_ITERATIONS = 50
# the budget at which the cluster kernel's sum-product row is held to its
# plain version at the A=8000 row's shape
CLUSTER_SP_ITERATIONS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def case_variant(variant, params, n, kw, sms):
    """The row of the ``kernels`` line a compared case counts for.  A
    layered launch in the warp form counts for V7-layered.  A
    one-codeword flooding launch in a cluster layout (``launch_shape``'s
    layout 2 or 3) runs ``ldpc_flooding_cluster_kernel``, a __global__ of its
    own with a row per instantiation: sum-product, the min-sum family with
    float32 messages, and with bfloat16 messages."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    if kw.get("schedule") != "flooding":
        # a layered launch that the automatic rule gives the warp form (the
        # min-sum family at small Z) runs the warp kernel, V7-layered's
        P = decoder_cuda.resolve_codewords_per_block(
            params, n, "layered", kw.get("codewords_per_block", 0),
            kw.get("algorithm", "min-sum"), kw.get("message_dtype", "float32"), sms)
        warp = decoder_cuda.warp_form(params, P, kw.get("algorithm", "min-sum"))
        return "V7-layered" if warp else variant
    shape = decoder_cuda.launch_shape(
        params, n, "flooding", kw.get("codewords_per_block", 0), sms)
    if shape["layout"] < 2:
        return variant
    if kw.get("algorithm", "min-sum") == "sum-product":
        return "V3-SP-cluster"
    return "V6-flooding-cluster" if kw.get("message_dtype") == "bfloat16" else "V3-NMS-cluster"


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

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(variant, params, llr, **kw):
        n = llr.numel() // llr.shape[-1]
        tally.add(case_variant(variant, params, n, kw, sms), compare_case(params, llr, **kw))

    ds = dict(channel_format="d", output_format="sys")
    v1 = dict(algorithm="min-sum", **ds)
    shapes = [
        # (params, waterfall dB, low dB, codewords, first-slice variants?,
        #  this slice's variants?)
        (LDPCParams(**FLAGSHIP), -0.75, -4.0, 48, False, False),
        (LDPCParams(BG=2, A=100, G=300, Q_m=2), 1.0, -6.0, 64, True, True),  # Z=20
        (LDPCParams(BG=2, A=400, G=1200, Q_m=2), 0.0, -6.0, 64, True, True),  # Z=52
        (LDPCParams(BG=1, A=44, G=132, Q_m=1), 1.0, -6.0, 64, True, False),  # Z=3
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
    return (phase_layout_edges(dev, check), phase_config1_launch(dev, check),
            phase_tie_cases(dev, check))


def tied(llr):
    """LLRs on a grid of six levels, +-0.5, +-1.5, +-2.5 (``floor(x) + 0.5``,
    clamped): rows tie at their smallest magnitude in sweep 0, and under
    offset-min-sum with beta 0.5, whose values stay on a grid of 0.5, in
    every sweep; no level is 0, so no LLR is -0.0."""
    return torch.clamp(torch.floor(llr) + 0.5, -2.5, 2.5)


def phase_tie_cases(dev, check):
    """The layered min-sum family's compressed messages where rows tie at
    their smallest magnitude (``tied`` LLRs): V1 at the flagship shape, at
    BG2 Z=20 and at BG1 Z=13; offset-min-sum with beta = 0.5, where the
    smallest magnitudes of
    the grid become 0 and messages +-0.0 ('cw' in and out, natural order);
    bfloat16 messages; the packed kernel with CONFIG1_PACK codewords per
    block.  Layered sum-product (V2, its rows at their own degree with their
    messages staged ahead) on the same LLRs: every BG2 degree at Z=20 (and
    packed), BG1's rows of 19 at the flagship shape (3 sweeps: its plain
    version takes seconds per sweep there).  Around the waterfall, so that
    codewords stop at different sweeps.  The one-codeword flooding kernel's
    min-sum family (rows at their own degree) on tied LLRs at Z=20 and at
    the largest one-block Z of each base graph (BG2 Z=224, BG1 Z=144):
    min-sum, offset-min-sum with beta 0.5 ('cw' in and out, run to the
    budget), bfloat16 messages.  Returns the share of LLRs at the smallest
    level, per shape."""
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
    from ldpc_3gpp_tpu_torch.tools.small_z import params_for_z

    ds = dict(channel_format="d", output_format="sys")
    oms = dict(algorithm="offset-min-sum", beta=0.5, layer_order="natural")
    out = {}
    for params, db, n in ((LDPCParams(**FLAGSHIP), -0.75, 48),
                          (LDPCParams(**CONFIG1_FIELDS), 1.0, 64),
                          (params_for_z(1, 13), 1.0, 64)):
        d = tied(noisy_d_tilde(params, "QPSK", db, n, 15, dev)[0][:, 0])
        cw = codeword_llrs(params, d)
        out[f"bg{params.BG}_z{params.Z_c}"] = float((d.abs() == 0.5).float().mean())
        check("V1", params, d, iterations=ITERATIONS, algorithm="min-sum", **ds)
        check("V1'", params, cw, iterations=ITERATIONS, **oms)
        check("V6-layered", params, d, iterations=ITERATIONS, algorithm="min-sum",
              message_dtype="bfloat16", **ds)
        check("V6-layered", params, cw, iterations=ITERATIONS, message_dtype="bfloat16",
              early_termination=False, **oms)
        sp = dict(algorithm="sum-product", iterations=3 if params.Z_c == 384 else P2_ITERATIONS)
        check("V2", params, d, **sp, **ds)
        check("V2", params, cw, early_termination=False, layer_order="natural", **sp)
        if params.Z_c == 20:
            check("V7-layered", params, d, codewords_per_block=CONFIG1_PACK, **sp, **ds)
            check("V7-layered", params, d, iterations=ITERATIONS, algorithm="min-sum",
                  codewords_per_block=CONFIG1_PACK, **ds)
            check("V7-layered", params, cw, iterations=ITERATIONS, message_dtype="bfloat16",
                  codewords_per_block=CONFIG1_PACK, **oms)
    fl = dict(schedule="flooding", iterations=12)
    for params in (LDPCParams(**CONFIG1_FIELDS), params_for_z(2, 224), params_for_z(1, 144)):
        n = 264 if params.Z_c > 20 else CONFIG1_BATCH
        d = tied(noisy_d_tilde(params, "QPSK", 1.0 if params.BG == 2 else 0.5, n, 16,
                               dev)[0][:, 0])
        cw = codeword_llrs(params, d)
        out[f"flooding_bg{params.BG}_z{params.Z_c}"] = float((d.abs() == 0.5).float().mean())
        check("V3-NMS-config1" if params.Z_c == 20 else "V3-NMS", params, d,
              algorithm="min-sum", **fl, **ds)
        check("V4-flooding", params, cw, algorithm="offset-min-sum", beta=0.5,
              early_termination=False, **fl)
        check("V6-flooding", params, d, algorithm="offset-min-sum", beta=0.5,
              message_dtype="bfloat16", **fl, **ds)
    return out


def phase_config1_launch(dev, check):
    """The one-codeword flooding kernel at config #1's launch as
    ``bler_vs_snr`` makes it (BG2 A=100 R=1/2, Z=20, CONFIG1_BATCH
    codewords, 50 iterations), where the block-size rule shares each SM
    among several smaller blocks: min-sum and offset-min-sum with bfloat16
    messages and early termination ('d' in, 'sys' out), min-sum with an alpha
    schedule run to budget ('cw' in and out), sum-product at 8 iterations;
    half the codewords at 1.0 dB, half at 3.0 dB (sweeps to convergence from
    0 to the budget); min-sum with bfloat16 messages and an alpha schedule.
    Raises unless the launch has fewer than FLOODING_MAX_THREADS threads per
    block and more than one block per SM in every instantiation.  Returns
    the launch shape."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    params = LDPCParams(**CONFIG1_FIELDS)
    n = CONFIG1_BATCH
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = decoder_cuda.launch_shape(params, n, "flooding", 0, sms)
    per_sm = {f"{rule}/{dtype}": decoder_cuda.blocks_per_sm(
        params, "flooding", rule, dtype, 1, n)
        for rule, dtype in (("min-sum", "float32"), ("offset-min-sum", "bfloat16"),
                            ("sum-product", "float32"))}
    if (shape["codewords_per_block"] != 1
            or shape["threads"] >= decoder_cuda.FLOODING_MAX_THREADS
            or min(per_sm.values()) < 2):
        raise AssertionError(f"config #1's launch is not a shared-SM shape: {shape} {per_sm}")
    d = torch.cat([noisy_d_tilde(params, "QPSK", db, n // 2, 14 + i, dev)[0][:, 0]
                   for i, db in enumerate((1.0, 3.0))])
    ds = dict(schedule="flooding", channel_format="d", output_format="sys")
    check("V3-NMS-config1", params, d, algorithm="min-sum", iterations=50, **ds)
    check("V6-flooding", params, d, algorithm="offset-min-sum", message_dtype="bfloat16",
          iterations=50, **ds)
    check("V6-flooding", params, d, algorithm="min-sum", message_dtype="bfloat16",
          alpha_schedule=(0.65, 2), iterations=50, **ds)
    check("V4-flooding", params, codeword_llrs(params, d), schedule="flooding",
          algorithm="min-sum", alpha_schedule=(0.65, 2), iterations=20,
          early_termination=False)
    check("V3-SP", params, d, algorithm="sum-product", iterations=P2_ITERATIONS, **ds)
    return dict(codewords=n, blocks_per_sm=per_sm, **shape)


def phase_layout_edges(dev, check):
    """The one-codeword flooding kernel at every edge of its layouts
    (LAYOUT_EDGES): per shape the three rules with early termination ('d'
    in, 'sys' out; min-sum with an alpha schedule) and run to budget ('cw'
    in and out), on codewords that pass at once, never pass and pass after a
    few sweeps.  Sum-product has float32 messages only, so at the shapes
    listed for bfloat16 it is the float32 case of a neighbouring shape's
    layout and is left out (its plain version costs seconds per sweep).
    Returns the launch shape of every base graph and Z."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.tools.small_z import noisy_llrs, params_for_z
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ds = dict(channel_format="d", output_format="sys", schedule="flooding")
    fl = dict(schedule="flooding", early_termination=False)
    shapes = []
    # BG1 Z=384 as snr_vs_a runs it at A=8000: 424 fillers in a cluster
    sweep = LDPCParams(**SWEEP_ROWS["V3-SP-sweep"][0])
    for bg, Z, dtype in LAYOUT_EDGES:
        params = sweep if (bg, Z) == (sweep.BG, sweep.Z_c) else params_for_z(bg, Z)
        n = LAYOUT_EDGE_CODEWORDS
        third = n // 3
        d = torch.cat([noisy_llrs(params, third, 6.0, 50 + Z, dev),
                       noisy_llrs(params, third, -8.0, 51 + Z, dev),
                       noisy_llrs(params, n - 2 * third, 0.0, 52 + Z, dev)])
        cw = codeword_llrs(params, d)
        family = "V6-flooding" if dtype == "bfloat16" else None
        if family is None:
            check("V3-SP", params, d, algorithm="sum-product", iterations=3, **ds)
            check("V4-flooding", params, cw, algorithm="sum-product", iterations=2, **fl)
        for rule, tag, extra in (("min-sum", "V3-NMS", dict(alpha_schedule=(0.65, 2))),
                                 ("offset-min-sum", "V3-OMS", {})):
            check(family or tag, params, d, algorithm=rule, iterations=5,
                  message_dtype=dtype, **extra, **ds)
            check(family or "V4-flooding", params, cw, algorithm=rule, iterations=3,
                  message_dtype=dtype, **fl)
        shapes.append(dict(bg=bg, Z=Z, message_dtype=dtype, codewords=n,
                           **decoder_cuda.launch_shape(params, n, "flooding", 0, sms)))
    layouts = {r["layout"] for r in shapes}  # one block, clusters of 2 and 3
    if layouts != {1, 2, 3}:
        raise AssertionError(f"the layout edges miss a layout or block size: {shapes}")
    return shapes


class Stopwatch:
    """Seconds since the last lap, for the phase records."""

    def __init__(self):
        self.last = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        seconds, self.last = now - self.last, now
        return seconds


def phase_packed_vs_plain(dev, tally):
    """Several codewords per block: packed == ``codewords_per_block=1``
    (every case) == plain (one of the twelve combinations per Z, in turn; the
    one-codeword kernels are held against it in ``kernel_vs_plain``),
    tolerance 0, for every Z of PACKED_ZS (base graph 1 at Z = 2, 5,
    13, 36, 96), both schedules and the three rules; per rule one case with
    f32 messages, 'd'/'sys' and early termination and one with 'cw' in and
    out run to budget (bfloat16 messages for the min-sum family).  53
    codewords, so every P leaves a ragged last block: 16 at high SNR (whole
    blocks that pass at once), 16 of noise (whole blocks that never pass),
    21 around the waterfall (0.5 and 1.5 dB at rate 1/3: the codewords of a block stop at different
    sweeps).  At Z <= 32 the layered launches also run at every P the
    automatic rule picks and at one that leaves a warp ragged (the warp
    kernel), once more on the codewords shuffled so that a warp's codewords
    come from all three groups, and on tied LLRs against the plain version
    (``warp_form_ties``).  Returns {Z/schedule: the P values compared}, per Z
    and schedule [most sweeps of the high-SNR group, fewest of the noise
    group, distinct counts in the waterfall group], and the cases held to the
    plain version."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.tools.small_z import noisy_llrs, params_for_z

    compared, mixes, plain_cases = {}, {}, 0
    shuffle = torch.randperm(53, generator=torch.Generator().manual_seed(53)).to(dev)
    for Z in PACKED_ZS:
        params = params_for_z(1 if Z in (2, 5, 13, 36, 96) else 2, Z)
        d = torch.cat([noisy_llrs(params, 16, 12.0, 40 + Z, dev),
                       noisy_llrs(params, 16, -12.0, 41 + Z, dev),
                       noisy_llrs(params, 11, 0.5, 42 + Z, dev),
                       noisy_llrs(params, 10, 1.5, 43 + Z, dev)])
        cw = codeword_llrs(params, d)
        combination = 0
        for schedule in ("layered", "flooding"):
            fit = [P for P in (2, 4, 8, 16) if decoder_cuda._fits(schedule, params, P)]
            ps = sorted({fit[0], fit[-1]}) if fit else []
            if schedule == "layered" and Z <= decoder_cuda.WARP_FORM_MAX_Z:
                # the warp form: every P the rule picks, and a last warp ragged
                G = 32 // Z
                ps = sorted(set(ps) | rule_ps(params) | {G + G // 2 if G > 1 else 3})
            compared[f"{Z}/{schedule}"] = ps
            if not fit:  # nothing to pack: asking for it raises
                try:
                    decoder_cuda.decode(params, d, schedule=schedule,
                                        channel_format="d", codewords_per_block=2)
                except ValueError:
                    continue
                raise AssertionError(f"codewords_per_block=2 at Z={Z} did not raise")
            for rule in ("min-sum", "offset-min-sum", "sum-product"):
                family = {} if rule == "sum-product" else dict(message_dtype="bfloat16")
                for llr, kw in (
                    (d, dict(channel_format="d", output_format="sys")),
                    (cw, dict(early_termination=False, **family)),
                ):
                    kw = dict(kw, schedule=schedule, algorithm=rule, iterations=8)
                    one = decoder_cuda.decode(params, llr, codewords_per_block=1, **kw)
                    # the plain version is slow: it takes one of the twelve
                    # combinations per Z, in turn (ten of them over the Zs)
                    if combination == 5 * PACKED_ZS.index(Z) % 12:
                        require_equal(
                            one, decoder_cuda.decode_plain(params, llr, **kw), kw)
                        plain_cases += 1
                    combination += 1
                    for P in ps:
                        got = decoder_cuda.decode(params, llr, codewords_per_block=P, **kw)
                        torch.cuda.synchronize()
                        tally.add(f"V7-{schedule}",
                                  require_equal(got, one, dict(kw, Z=Z, P=P)))
                        if schedule == "layered" and decoder_cuda.warp_form(params, P, rule):
                            # a warp's codewords from all three groups
                            got = decoder_cuda.decode(params, llr[shuffle], codewords_per_block=P,
                                                      **kw)
                            torch.cuda.synchronize()
                            tally.add("V7-layered", require_equal(
                                got, type(one)(*(f[shuffle] for f in one)),
                                dict(kw, Z=Z, P=P, shuffled=True)))
                    if kw.get("early_termination", True) and rule == "min-sum":
                        its = one.iterations.tolist()
                        mixes[f"{Z}/{schedule}"] = [
                            max(its[:16]), min(its[16:32]), len(set(its[32:]))]
        if Z <= decoder_cuda.WARP_FORM_MAX_Z:
            plain_cases += warp_form_ties(params, d, tally)
    # the point of the three groups: early blocks, blocks that never pass, and
    # blocks whose codewords stop at different sweeps
    mixed = sum(1 for hi, lo, kinds in mixes.values() if hi < lo and kinds > 1)
    if mixed < len(mixes) // 2:
        raise AssertionError(f"the LLRs do not mix sweeps within blocks: {mixes}")
    return compared, mixes, plain_cases


def rule_ps(params):
    """The codewords per block (above 1) that the automatic rule picks for
    this code's layered min-sum launches, at a sweep's call and at bulk,
    with float32 and with bfloat16 messages."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    return {P for n in (256, 2048, 16384, 65536) for dtype in ("float32", "bfloat16")
            for P in (decoder_cuda.auto_codewords_per_block(params, n, "layered", "min-sum",
                                                            dtype),) if P > 1}


def warp_form_rounds(dev, tally):
    """The warp kernel at a sweep's call and above against the plain
    version, tolerance 0: 4,096 codewords of BG2 Z=32 with bfloat16 messages
    at the automatic rule's P (its widest block: 12 warps, 384 lanes),
    min-sum with early termination ('d' in, 'sys' out); and config #1's code
    at CONFIG1_PACK
    codewords per block, bfloat16 offset-min-sum run to budget ('cw' in and
    out), at 4,096 codewords, above what the SMs hold at once (2,112 on 132
    SMs), so that persistent warps take codewords a second time (their
    words zeroed, their votes reset).  Returns {case: launch shape}."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
    from ldpc_3gpp_tpu_torch.tools.small_z import noisy_llrs, params_for_z

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    z32, config1 = params_for_z(2, 32), LDPCParams(**CONFIG1_FIELDS)
    for name, params, llr, kw in (
        ("bg2_z32_bf16_rule", z32, noisy_llrs(z32, 2 * CONFIG1_BATCH, 1.0, 60, dev),
         dict(channel_format="d", output_format="sys", algorithm="min-sum",
              message_dtype="bfloat16", iterations=ITERATIONS)),
        ("config1_bf16_oms_budget", config1,
         codeword_llrs(config1, noisy_llrs(config1, 2 * CONFIG1_BATCH, 1.5, 61, dev)),
         dict(algorithm="offset-min-sum", message_dtype="bfloat16", iterations=ITERATIONS,
              early_termination=False, codewords_per_block=CONFIG1_PACK)),
    ):
        n = llr.shape[0]
        shape = decoder_cuda.launch_shape(params, n, "layered", kw.get("codewords_per_block", 0),
                                          sms, kw["algorithm"], kw["message_dtype"])
        P = shape["codewords_per_block"]
        per_sm = decoder_cuda.blocks_per_sm(params, "layered", kw["algorithm"],
                                            kw["message_dtype"], P, n)
        at_once = sms * per_sm * P
        if not decoder_cuda.warp_form(params, P, kw["algorithm"]) or P * params.Z_c > 384:
            raise AssertionError(f"{name}: not a warp-form launch within 384 lanes: {shape}")
        if "codewords_per_block" in kw and n <= at_once:
            raise AssertionError(f"{name}: {n} codewords take no second round ({at_once})")
        got = decoder_cuda.decode(params, llr, **kw)
        torch.cuda.synchronize()
        tally.add("V7-layered", require_equal(got, decoder_cuda.decode_plain(params, llr, **kw),
                                              dict(kw, case=name)))
        out[name] = dict(shape, codewords=n, blocks_per_sm=per_sm, codewords_at_once=at_once)
    return out


def warp_form_ties(params, d, tally):
    """The warp kernel on ``tied`` LLRs (rows tie at their smallest
    magnitude) at every P the rule picks (or 4) against the plain version,
    tolerance 0: min-sum with early termination ('d' in, 'sys' out) and
    offset-min-sum with beta 0.5 and bfloat16 messages run to budget ('cw'
    in and out, natural order; zero magnitudes).  Returns the cases."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    t = tied(d)
    cases = 0
    for llr, kw in ((t, dict(channel_format="d", output_format="sys", algorithm="min-sum",
                             iterations=ITERATIONS)),
                    (codeword_llrs(params, t), dict(algorithm="offset-min-sum", beta=0.5,
                                                    message_dtype="bfloat16", iterations=8,
                                                    early_termination=False,
                                                    layer_order="natural"))):
        want = decoder_cuda.decode_plain(params, llr, **kw)
        for P in sorted(rule_ps(params)) or [4]:
            got = decoder_cuda.decode(params, llr, codewords_per_block=P, **kw)
            torch.cuda.synchronize()
            tally.add("V7-layered", require_equal(got, want, dict(kw, Z=params.Z_c, P=P,
                                                                  tied=True)))
            cases += 1
    return cases


# The packed flooding kernel's cases beyond ``packed_vs_plain``: (base graph,
# Z, codewords per block, the layout they must run in).
PACKED_FLOODING_CASES = ((2, 20, (2, 4, 8), 1), (1, 96, (2,), 0))


def phase_packed_flooding(dev, tally):
    """The packed flooding kernel, messages on chip (BG2 Z=20, P = 2, 4, 8)
    and in its scratch form (BG1 Z=96, P=2), on ``packed_vs_plain``'s mix of
    53 codewords (whole blocks that pass at once, whole blocks that never
    pass, blocks whose codewords stop at different sweeps, a ragged last
    block): sum-product, min-sum, offset-min-sum and min-sum with bfloat16
    messages, early termination ('d' in, 'sys' out) and, per rule, a run to
    budget ('cw' in and out).  Each equals the plain version (tolerance 0).
    Returns the launch shapes."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.tools.small_z import noisy_llrs, params_for_z

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for bg, Z, ps, layout in PACKED_FLOODING_CASES:
        params = params_for_z(bg, Z)
        d = torch.cat([noisy_llrs(params, 16, 12.0, 60 + Z, dev),
                       noisy_llrs(params, 16, -12.0, 61 + Z, dev),
                       noisy_llrs(params, 11, 0.5, 62 + Z, dev),
                       noisy_llrs(params, 10, 1.5, 63 + Z, dev)])
        cw = codeword_llrs(params, d)
        for rule, dtype in (("sum-product", "float32"), ("min-sum", "float32"),
                            ("offset-min-sum", "float32"), ("min-sum", "bfloat16")):
            base = dict(schedule="flooding", algorithm=rule, message_dtype=dtype,
                        iterations=P2_ITERATIONS)
            for llr, kw in ((d, dict(base, channel_format="d", output_format="sys")),
                            (cw, dict(base, early_termination=False))):
                want = decoder_cuda.decode_plain(params, llr, **kw)
                for P in ps:
                    shape = decoder_cuda.launch_shape(params, llr.shape[0], "flooding", P, sms)
                    if shape["layout"] != layout:
                        raise AssertionError(f"packed flooding at Z={Z}, P={P}: {shape}")
                    got = decoder_cuda.decode(params, llr, codewords_per_block=P, **kw)
                    torch.cuda.synchronize()
                    tally.add("V7-flooding", require_equal(got, want, dict(kw, Z=Z, P=P)))
        shapes += [dict(bg=bg, Z=Z, **decoder_cuda.launch_shape(params, 53, "flooding", P, sms))
                   for P in ps]
    return shapes


def phase_lifting_sweep(dev):
    """Every lifting size of both base graphs, alternating 16QAM and 64QAM:
    the configurations of ``ldpc_3gpp_tpu_torch/tools/lifting_sweep.py``
    (min-sum, flooding, 20 iterations), each held equal to its record in
    golden/lifting_sweep.json (made by the JAX package's tool), 16 blocks
    each at 30 dB through the tool's round trip, ``simulate_batch`` and the
    kernel (backend 'auto').  As in the golden, no block may fail."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.tools import lifting_sweep

    with open(os.path.join(ROOT, "golden", "lifting_sweep.json")) as f:
        golden = json.load(f)
    if golden["high_snr_failures"] != 0:
        raise AssertionError("the golden itself records high-SNR failures")
    records = [r for r in golden["results"] if r["status"] != "unsupported"]
    torch.cuda.synchronize()
    decoder_cuda.reset_launches()
    configs, failures, zs = 0, [], set()
    for (bg, Z, mod, rate, params), rec in zip(
            (c for c in lifting_sweep.sweep_configs() if c[4] is not None), records):
        if ((bg, Z, params.A, params.G, mod, round(rate, 4))
                != (rec["bg"], rec["Z"], rec["A"], rec["G"], rec["modulation"], rec["rate"])):
            raise AssertionError(f"the tool's configuration differs from the golden's: {rec}")
        blocks, errors = lifting_sweep.high_snr_errors(params, mod, Z, 16, dev)
        configs += 1
        zs.add((bg, Z))
        if errors or blocks != 16:
            failures.append(dict(bg=bg, Z=Z, blocks=blocks, errors=errors))
    torch.cuda.synchronize()
    out = dict(configs=configs, golden_configs=golden["configs_run"],
               lifting_sizes=len(zs), block_errors=failures,
               launches=dict(decoder_cuda.LAUNCHES), launches_by_P=launches_by_p(),
               cluster_launches=cluster_launches())
    if (failures or configs != golden["configs_run"]
            or out["launches"] != {"ldpc_layered": 0, "ldpc_flooding": configs}):
        raise AssertionError(f"lifting sweep: {out}")
    return out


def launches_by_p():
    """``decoder_cuda.LAUNCHES_BY_P`` with printable keys."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    return {f"{k}/P={p}/layout={l}": n
            for (k, p, l), n in sorted(decoder_cuda.LAUNCHES_BY_P.items())}


def cluster_launches():
    """Launches of the flooding cluster kernel (layout 2 or 3) since the
    counts were last set to 0."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    return sum(n for (_, _, layout), n in decoder_cuda.LAUNCHES_BY_P.items() if layout >= 2)


def two_sample_gate(name, esn0_db, blocks, errors, golden_blocks, golden_errors):
    """This run's error rate against the golden's, samples of different
    sizes: the difference of the rates has variance p (1-p) (1/n1 + 1/n2)
    with p the pooled rate; the bound is 5 sigma plus one block of each."""
    p = (errors + golden_errors) / (blocks + golden_blocks)
    bound = (5.0 * math.sqrt(p * (1.0 - p) * (1.0 / blocks + 1.0 / golden_blocks))
             + 1.0 / blocks + 1.0 / golden_blocks)
    rec = dict(path=name, esn0_db=esn0_db, blocks=blocks, block_errors=errors,
               golden_blocks=golden_blocks, golden_block_errors=golden_errors,
               bler=errors / blocks, golden_bler=golden_errors / golden_blocks,
               bound_bler=bound)
    if abs(rec["bler"] - rec["golden_bler"]) > bound:
        raise AssertionError(f"BLER outside the golden's binomial bound: {rec}")
    return rec


def phase_path_5(dev):
    """P5, the sweeps on the card, into a temporary results directory.

    ``snr_vs_a`` with the reference's defaults: every required Es/N0 within
    SNR_VS_A_TOLERANCE_DB of the golden, the results file under the
    reference's name and in its format.  ``bler_vs_snr`` at config #1 with
    100 block errors per point, target BLER 1e-2, 2,048 blocks per call:
    every point inside the two-sample bound of the golden curve; the
    automatic rule packs no launch of either sweep.  The same sweep, same
    seed, with ``codewords_per_block=CONFIG1_PACK`` asked for: every launch
    packed, every ``SweepPoint`` and the results file equal to the first
    run's (packing changes no result)."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.parallel.sweep import bler_vs_snr, snr_vs_a

    with open(os.path.join(ROOT, "golden", SNR_VS_A_GOLDEN)) as f:
        golden_a = json.load(f)
    with open(os.path.join(ROOT, "golden", CONFIG1_GOLDEN)) as f:
        golden_1 = json.load(f)
    out = {}
    with tempfile.TemporaryDirectory() as results_dir:
        torch.cuda.synchronize()
        decoder_cuda.reset_launches()
        t0 = time.perf_counter()
        curve = snr_vs_a(results_dir=results_dir, device=dev, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(decoder_cuda.LAUNCHES)
        (rate, points), = curve.items()
        fname = os.path.join(results_dir, "SNR_vs_A_0.01_0.333333_1_QPSK_50_100_0.txt")
        with open(fname) as f:
            text = f.read()
        if text != "".join(f"{a}\t{req:f}\n" for a, req in points):
            raise AssertionError(f"results file is not in the reference's format: {text!r}")
        worst = max(abs(req - g) for (_, req), g in
                    zip(points, golden_a["required_esn0_db"]))
        blocks = launches["ldpc_flooding"] * 256  # one code block per block
        out["snr_vs_a"] = dict(
            A=[a for a, _ in points], required_esn0_db=[req for _, req in points],
            golden_required_esn0_db=golden_a["required_esn0_db"],
            max_abs_diff_db=worst, tolerance_db=SNR_VS_A_TOLERANCE_DB,
            results_file=os.path.basename(fname), seconds=seconds, blocks=blocks,
            blocks_per_s=blocks / seconds, launches=launches,
            launches_by_P=launches_by_p(), cluster_launches=cluster_launches())
        if ([a for a, _ in points] != golden_a["A"] or worst > SNR_VS_A_TOLERANCE_DB
                or launches["ldpc_flooding"] < 1 or launches["ldpc_layered"]
                or out["snr_vs_a"]["cluster_launches"] < 1):
            raise AssertionError(f"snr_vs_a outside its gate: {out['snr_vs_a']}")

        torch.cuda.synchronize()
        decoder_cuda.reset_launches()
        t0 = time.perf_counter()
        curves = bler_vs_snr(
            A=[CONFIG1_FIELDS["A"]], rate=[1 / 2], bg=[2], modulation="QPSK",
            iterations=50, target_block_errors=100, target_bler=1e-2,
            algorithm="min-sum", batch_per_device=CONFIG1_BATCH,
            results_dir=results_dir, device=dev, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(decoder_cuda.LAUNCHES)
        by_p = dict(decoder_cuda.LAUNCHES_BY_P)
        (_, pts), = curves.items()
        fname = os.path.join(results_dir, "BLER_vs_SNR_100_0.5_2_QPSK_50_100_0_0.txt")
        with open(fname) as f:
            text = f.read()
        want = "".join(f"{pt.esn0_db:f}\t{pt.bler:e}\n" for pt in pts if pt.bler < 1)
        if text != want or any(pt.capped for pt in pts):
            raise AssertionError(f"results file is not in the reference's format: {text!r}")
        gates = []
        for pt in pts:
            i = golden_1["esn0_db"].index(pt.esn0_db)
            g_blocks = golden_1["blocks"][i]
            gates.append(two_sample_gate(
                "P5/config1", pt.esn0_db, pt.blocks, pt.block_errors, g_blocks,
                round(golden_1["bler"][i] * g_blocks)))
        blocks = sum(pt.blocks for pt in pts)
        packed = sum(n for (_, p, _), n in by_p.items() if p > 1)
        out["bler_vs_snr"] = dict(
            points=gates, results_file=os.path.basename(fname), seconds=seconds,
            blocks=blocks, blocks_per_s=blocks / seconds, launches=launches,
            launches_by_P=launches_by_p(), packed_launches=packed)
        if (pts[-1].bler > 1e-2 or len(pts) < 8 or packed
                or blocks != launches["ldpc_flooding"] * CONFIG1_BATCH):
            raise AssertionError(f"bler_vs_snr outside its gate: {out['bler_vs_snr']}")

        packed_dir = os.path.join(results_dir, "packed")
        torch.cuda.synchronize()
        decoder_cuda.reset_launches()
        t0 = time.perf_counter()
        curves = bler_vs_snr(
            A=[CONFIG1_FIELDS["A"]], rate=[1 / 2], bg=[2], modulation="QPSK",
            iterations=50, target_block_errors=100, target_bler=1e-2,
            algorithm="min-sum", batch_per_device=CONFIG1_BATCH,
            results_dir=packed_dir, device=dev, verbose=False,
            codewords_per_block=CONFIG1_PACK)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(decoder_cuda.LAUNCHES)
        by_p = dict(decoder_cuda.LAUNCHES_BY_P)
        (_, packed_pts), = curves.items()
        with open(os.path.join(packed_dir, os.path.basename(fname))) as f:
            packed_text = f.read()
        differing = [pt.esn0_db for pt, one in zip(packed_pts, pts)
                     if dataclasses.astuple(pt) != dataclasses.astuple(one)]
        out["bler_vs_snr_explicit_P"] = dict(
            codewords_per_block=CONFIG1_PACK, points=len(packed_pts),
            points_differing_from_automatic_run=differing, seconds=seconds,
            blocks=sum(pt.blocks for pt in packed_pts),
            blocks_per_s=sum(pt.blocks for pt in packed_pts) / seconds, launches=launches,
            launches_by_P=launches_by_p(),
            packed_launches=by_p.get(
                ("ldpc_flooding", CONFIG1_PACK, decoder_cuda.LAYOUT_ON_CHIP), 0))
        if (differing or len(packed_pts) != len(pts) or packed_text != text
                or launches != out["bler_vs_snr"]["launches"]
                or by_p != {("ldpc_flooding", CONFIG1_PACK, decoder_cuda.LAYOUT_ON_CHIP):
                            launches["ldpc_flooding"]}):
            raise AssertionError(
                f"packed sweep differs from the one-codeword sweep: "
                f"{out['bler_vs_snr_explicit_P']}")
    return out


def phase_qam64_gate(dev):
    """``MonteCarlo.run`` at BG1 A=8424 R=1/2 64QAM, layered min-sum, 12
    iterations: block errors at 10.5 and 10.75 dB inside the 5-sigma bound of
    golden/bench_path_bler.json QAM64_R12 (samples of the golden's sizes)."""
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    with open(os.path.join(ROOT, "golden", "bench_path_bler.json")) as f:
        curve = json.load(f)["QAM64_R12"]
    params = LDPCParams(BG=1, A=8424, G=16848, Q_m=6)
    assert params.Z_c == 384 and params.C == 1
    cfg = ChainConfig(params=params, modulation="64QAM", iterations=ITERATIONS,
                      algorithm="min-sum", schedule="layered")
    mc = MonteCarlo(cfg, batch_per_device=1024, steps_per_call=2, device=dev)
    generator = make_generator(6, dev)
    torch.cuda.synchronize()
    decoder_cuda.reset_launches()
    out = []
    for esn0_db in (10.5, 10.75):
        i = curve["esn0_db"].index(esn0_db)
        n = curve["blocks"][i]
        c = mc.run_pipelined(generator, esn0_db, n // mc.blocks_per_run)
        if int(c["iteration_hist"].sum()) != c["blocks"]:
            raise AssertionError("iteration histogram does not count every block")
        out.append(binomial_gate("QAM64_R12", esn0_db, c["blocks"], c["block_errors"],
                                 curve["block_errors"][i], n))
    launches = dict(decoder_cuda.LAUNCHES)
    expect_launches(launches, "ldpc_layered", (2048 + 6144) // 1024)
    return out, launches


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


def snr_vs_a_config():
    """``snr_vs_a``'s configuration at the ``V3-SP-sweep`` row's A (BG1
    A=8000 R=1/3 QPSK, the reference's decoder at 50 iterations), as the
    sweep builds it: its flooding launches run in a cluster of 3 blocks."""
    from ldpc_3gpp_tpu_torch.parallel.sweep import _make_config

    fields, _ = SWEEP_ROWS["V3-SP-sweep"]
    cfg = _make_config(fields["A"], 1 / 3, fields["BG"], "QPSK", (0,),
                       SWEEP_ITERATIONS, "sum-product")
    assert cfg.params.Z_c == 384 and cfg.params.G == fields["G"]
    return cfg


def p3_config(schedule):
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    params = LDPCParams(**P3_FIELDS)
    assert params.C == 1 and params.Z_c == 208
    return ChainConfig(params=params, iterations=8, algorithm="sum-product",
                       schedule=schedule)


def config1_config(**kw):
    """BASELINE config #1's code (Z=20) with normalized min-sum."""
    from ldpc_3gpp_tpu_torch.models.chain import ChainConfig
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    params = LDPCParams(**CONFIG1_FIELDS)
    assert params.Z_c == 20 and params.C == 1
    return ChainConfig(params=params, iterations=ITERATIONS, algorithm="min-sum", **kw)


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
    "V7-layered": ("ldpc_layered", lambda: config1_config(
        schedule="layered", codewords_per_block=CONFIG1_PACK)),
}


def phase_variant_steps(generator, dev):
    """Launches per variant in one step at 1.0 dB each: 256 blocks, and for
    V7 config #1's 2,048 with ``codewords_per_block=CONFIG1_PACK`` asked for."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    out = {}
    for variant, (kernel, make) in VARIANT_STEPS.items():
        batch = CONFIG1_BATCH if variant.startswith("V7") else 256
        blocks, errors, _, n = counted_steps(make(), generator, 1.0, batch, 1, dev)
        expect_launches(n, kernel, 1)
        out[variant] = dict(launches=n[kernel], blocks=blocks, block_errors=errors,
                            launches_by_P=launches_by_p())
        packed = any(p > 1 for (_, p, _) in decoder_cuda.LAUNCHES_BY_P)
        if packed != variant.startswith("V7"):
            raise AssertionError(f"{variant}: unexpected codewords per block: {out[variant]}")
    return out


def phase_op_rates(dev, times):
    """K2.  Every class equals its plain version at a small loop count
    (tolerance 0: the number of values whose bits differ must be 0) in three
    small block shapes and then in the block shape, at the block count, of
    every timed kernel variant; with the launch count set to 0 before and read
    after, the rates in those shapes, from which each variant's
    ``measured_rate_ms`` follows.  The record's own timed input goes through
    the kernel and the plain version and is compared too.  Returns the K2
    record of the ``kernels`` line and the rates by shape."""
    from ldpc_3gpp_tpu_torch.tools import op_rates

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = 0

    def compare_all(blocks, threads, Z, E, blocks_per_sm):
        nonlocal cases
        for op in op_rates.CLASSES:
            differing = op_rates.compare(op, blocks, threads, Z, E, 2, dev, blocks_per_sm)
            if differing:
                raise AssertionError(
                    f"op_rates class {op} differs from its plain version in "
                    f"{differing} values at {blocks} blocks of {threads} threads, "
                    f"Z={Z}, E={E}, {blocks_per_sm} blocks per SM")
            cases += 1

    for blocks, threads, Z, E in ((5, 384, 384, 312), (7, 128, 104, 192), (9, 32, 20, 40)):
        compare_all(blocks, threads, Z, E, 2)

    torch.cuda.synchronize()
    op_rates.reset_launches()
    by_shape = {}
    for variant, m in times.items():
        key = rate_shape(m)
        if key not in by_shape:
            by_shape[key] = op_rates.rates(*key, dev)
        m.update(measured_rate(m, by_shape[key], m["algorithm"]))
    torch.cuda.synchronize()
    launches = op_rates.LAUNCHES[op_rates.KERNEL_NAME]

    # the shapes the rates were taken in, each held against the plain version
    for threads, Z, E, per_sm in by_shape:
        compare_all(sms * per_sm, threads, Z, op_rates.scratch_edges(E), per_sm)

    # the K2 record: the multiply/add class in the flagship's block shape, kernel
    # and plain version on the same input at the same small loop count
    loops, threads, per_sm = 2, 384, 2
    x = torch.from_numpy(op_rates.make_input("addmul", sms * per_sm, threads, threads)).to(dev)
    got = op_rates.run("addmul", x, loops, threads, 0, per_sm)
    torch.cuda.synchronize()
    want = op_rates.plain("addmul", x, loops)
    differing = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    max_abs_diff = float((got - want).abs().max())
    if differing or max_abs_diff != 0.0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"op_rates differs from its plain version on the timed input: "
            f"{differing} values, max abs diff {max_abs_diff}")
    cases += 1
    ms = time_ms(lambda: op_rates.run("addmul", x, loops, threads, 0, per_sm), reps=20)
    plain_ms = time_ms(lambda: op_rates.plain("addmul", x, loops), reps=2, warmup=1)
    w = op_rates.work("addmul", sms * per_sm, threads, threads, 0, loops)
    t_bytes = x.numel() * 8 / PEAK_BYTES_PER_S * 1e3
    t_ops = w["operations"] / PEAK_OPS_PER_S * 1e3
    record = dict(
        cases=cases, launches=launches, max_abs_diff=max_abs_diff,
        differing_values=differing, values_compared=got.numel(),
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops)
    rates = [
        {"threads": k[0], "Z": k[1], "E": k[2], "blocks_per_sm": k[3],
         **{op: (r["operations_per_s"] or r["bytes_per_s"]) for op, r in v.items()}}
        for k, v in by_shape.items()]
    return record, rates


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
               schedule=cfg.schedule, backend=cfg.backend,
               message_dtype=cfg.message_dtype)
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


def sweep_call_profile(dev, calls=5):
    """One ``snr_vs_a`` call as the sweep makes it at A=8000 near its
    required Es/N0 (``MonteCarlo.run`` of SWEEP_BATCH blocks, one fetch):
    host ms per call, and from ``torch.profiler`` the device busy and idle
    share and the flooding kernel's ms per call."""
    from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    fields, esn0_db = SWEEP_ROWS["V3-SP-sweep"]
    cfg = snr_vs_a_config()
    mc = MonteCarlo(cfg, batch_per_device=SWEEP_BATCH, steps_per_call=1, device=dev)
    generator = make_generator(7, dev)

    def call():
        return mc.run(generator, esn0_db)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        c = call()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / calls * 1e3
    prof = profile_steps(call, calls, call_ms)
    kernel_ms = None
    if prof["top"] is not None:
        kernel_ms = sum(r["ms_per_step"] for r in prof["top"]
                        if "ldpc_flooding" in r["name"])
    return dict(A=fields["A"], esn0_db=esn0_db, blocks=SWEEP_BATCH,
                block_errors_last_call=int(c["block_errors"]), host_ms_per_call=call_ms,
                flooding_kernel_ms_per_call=kernel_ms,
                kernel_share_of_call=None if kernel_ms is None else kernel_ms / call_ms,
                profile=prof)


def phase_times(generator, dev, card):
    """Every kernel variant at its path's shape, and P1's and P2's steps.
    Returns {variant: measurements}."""
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams
    from ldpc_3gpp_tpu_torch.tools.small_z import noisy_llrs

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
    # V1 at the flagship cell's launch: a step of FLAGSHIP_CELL_BATCH
    # codewords drawn on the card, held to the plain version once
    df = noisy_llrs(p1, FLAGSHIP_CELL_BATCH, MAIN_ESN0_DB, 28, dev)
    out["V1-flagship"] = measure_variant(p1, df, 3, **v1)
    del df
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

    # V3-NMS at the config #1 cell's launch: a step of CONFIG1_CELL_BATCH
    # codewords at 2.0 dB (one 128-thread block per codeword, eight per SM)
    pc = LDPCParams(**CONFIG1_FIELDS)
    dc, _ = noisy_d_tilde(pc, "QPSK", 2.0, CONFIG1_CELL_BATCH, 27, dev)
    out["V3-NMS-config1"] = measure_variant(pc, dc, 3, algorithm="min-sum",
                                            **dict(fl, iterations=50))
    del dc

    # snr_vs_a's launches at both ends of its range: the kernel alone (its
    # plain version would run 50 sweeps for minutes; these block shapes are
    # held to it in kernel_vs_plain)
    for name, (fields, esn0_db) in SWEEP_ROWS.items():
        ps = LDPCParams(**fields)
        d, _ = noisy_d_tilde(ps, "QPSK", esn0_db, SWEEP_BATCH, 25, dev)
        out[name] = measure_variant(ps, d, 10, plain=False, algorithm="sum-product",
                                    **dict(fl, iterations=SWEEP_ITERATIONS))
        out[name]["esn0_db"] = esn0_db
        del d

    # the cluster kernel (a cluster of 3 blocks per codeword) at the A=8000
    # row's shape, held to its plain version: sum-product at a budget of
    # CLUSTER_SP_ITERATIONS (its plain version takes seconds per sweep
    # there), the min-sum family at P2's 8
    fields, esn0_db = SWEEP_ROWS["V3-SP-sweep"]
    ps = LDPCParams(**fields)
    d, _ = noisy_d_tilde(ps, "QPSK", esn0_db, SWEEP_BATCH, 26, dev)
    out["V3-SP-cluster"] = measure_variant(
        ps, d, 10, algorithm="sum-product", **dict(fl, iterations=CLUSTER_SP_ITERATIONS))
    out["V3-NMS-cluster"] = measure_variant(ps, d, 10, algorithm="min-sum", **fl)
    for name in ("V3-SP-cluster", "V3-NMS-cluster"):
        if out[name]["layout"] < 2:
            raise AssertionError(f"{name} did not run in a cluster: {out[name]}")
        out[name]["esn0_db"] = esn0_db
    del d

    # P3's shape: (1024, 1, N) at 2.0 dB
    p3 = LDPCParams(**P3_FIELDS)
    d3, _ = noisy_d_tilde(p3, "QPSK", P3_ESN0_DB, MAIN_BATCH, 23, dev)
    out["V2"] = measure_variant(p3, d3, 10, algorithm="sum-product", iterations=8, **ds)
    del d3

    # V7 at the shape the sweep path hands the packed kernels, config #1's call
    # (Z=20, 2,048 codewords at 2.0 dB) with CONFIG1_PACK codewords per block,
    # and the one-codeword kernel beside it: layered at the variant step's 12
    # iterations, flooding at the sweep's 50
    p7 = LDPCParams(**CONFIG1_FIELDS)
    d7, _ = noisy_d_tilde(p7, "QPSK", 2.0, CONFIG1_BATCH, 24, dev)
    for name, kw in (
        ("V7-layered", dict(schedule="layered", iterations=ITERATIONS)),
        ("V7-flooding", dict(schedule="flooding", iterations=50)),
    ):
        kw = dict(kw, algorithm="min-sum", **ds)
        out[name] = measure_variant(p7, d7, 20, codewords_per_block=CONFIG1_PACK, **kw)
        assert out[name]["codewords_per_block"] == CONFIG1_PACK
        out[name]["ms_one_codeword_per_block"] = time_ms(
            lambda: decoder_cuda.decode(p7, d7, codewords_per_block=1, **kw), reps=20)
    v7 = dict(schedule="layered", iterations=ITERATIONS, algorithm="min-sum", **ds)
    out["V1-z20"] = measure_variant(p7, d7, 20, codewords_per_block=1, **v7)
    del d7
    # the warp form at the rule's codewords per block: config #1's code at a
    # bulk launch and BG2 Z=8 (the kernel alone: these launches are held to
    # the plain version at smaller batches in packed_vs_plain)
    for name, fields, n in (("V7-layered-65536", CONFIG1_FIELDS, 65536),
                            ("V7-layered-z8", dict(BG=2, A=32, G=64, Q_m=2), 16384)):
        pz = LDPCParams(**fields)
        dz, _ = noisy_d_tilde(pz, "QPSK", 2.0, n, 24, dev)
        out[name] = measure_variant(pz, dz, 5, plain=False, **v7)
        if not decoder_cuda.warp_form(pz, out[name]["codewords_per_block"]):
            raise AssertionError(f"{name} did not take the warp form: {out[name]}")
        del dz

    from ldpc_3gpp_tpu_torch.tools import small_z

    watch = Stopwatch()
    packing = small_z.packing_table(dev)
    # a sweep's conditions: 50 iterations above the waterfall, where a few
    # codewords run the whole budget and most stop early
    packing_50 = small_z.packing_table(dev, zs=(2, 8, 20), ns=(4096, 16384),
                                       iterations=50, esn0_db=3.0)
    packing_s = watch.lap()
    routing = small_z.routing_table(dev, zs=(2, 3, 5, 8, 12, 16), ns=(2048,))
    # the automatic choice must not lose to one codeword per block (30 %: the
    # largest loss in the tables it was derived from is 7 %)
    for row in packing + packing_50:
        us = {int(k): v for k, v in row["us_per_codeword"].items()}
        if row["auto_P"] != 1 and us[row["auto_P"]] > 1.3 * us[1]:
            raise AssertionError(f"automatic codewords_per_block loses: {row}")
    losses = [r for r in routing if not r["kernel_wins"]]
    from ldpc_3gpp_tpu_torch.ops.decoder_cuda import supports
    for r in routing:
        if supports(small_z.table_params(r["Z"])) != (
                not any(l["Z"] == r["Z"] for l in losses)):
            raise AssertionError(f"'auto' routing disagrees with the table: {r}")

    emit({"times": {
        "card": card,
        "small_z_packing": packing, "small_z_packing_budget_50": packing_50,
        "small_z_packing_seconds": packing_s,
        "small_z_routing": routing, "small_z_routing_seconds": watch.lap(),
        "kernels": {v: {k: m[k] for k in (
            "ms", "us_per_codeword", "plain_ms", "bound_ms", "bound_by",
            "scratch_traffic_ms", "mean_sweeps", "codewords",
            "codewords_per_block", "threads", "layout", "blocks_per_sm")}
            for v, m in out.items()},
        "snr_vs_a_call": sweep_call_profile(dev),
        "V7_ms_one_codeword_per_block": {
            v: out[v]["ms_one_codeword_per_block"] for v in ("V7-flooding", "V7-layered")},
        "kernel_us_per_codeword_at_4x_batch": out["V1"]["us_per_codeword_at_4x_batch"],
        "P1": step_times(flagship_config(), generator, MAIN_ESN0_DB, dev),
        "P4": step_times(flagship_config(message_dtype="bfloat16"), generator,
                         MAIN_ESN0_DB, dev),
        "P2": step_times(p2_config(), generator, MAIN_ESN0_DB, dev),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }})
    return out


# (variant, kernel source, lines of the TPU kernel it replaces)
# The 'mxu' encoder held to 'rolls' on the card: (fields, rows) — every
# small lifting size of the issue's list (Z = 2 exists in base graph 1 only),
# C > 1 at Z=208 and Z=320, the flagship at MAIN_BATCH rows; rows below 17
# and odd Z take the padding of torch._int_mm.
MXU_CASES = (
    (dict(BG=1, A=28, G=84, Q_m=2), 5),  # Z=2
    (dict(BG=2, A=2, G=6, Q_m=2), 300),  # Z=3
    (dict(BG=1, A=94, G=282, Q_m=2), 40),  # Z=5
    (dict(BG=2, A=26, G=78, Q_m=2), 17),  # Z=7
    (dict(BG=1, A=314, G=942, Q_m=2), 64),  # Z=15
    (dict(BG=2, A=74, G=222, Q_m=2), 16),  # Z=15
    (dict(BG=2, A=100, G=300, Q_m=2), 256),  # Z=20
    (dict(BG=2, A=3842, G=11526, Q_m=2), 300),  # Z=208, C=2
    (dict(BG=1, A=20004, G=60012, Q_m=2), 64),  # Z=320, C=3
    (FLAGSHIP, MAIN_BATCH),  # Z=384
)


def phase_mxu_encoder(dev):
    """The matrix encoder on the card: ``encode_mxu`` equal to the roll/XOR
    encoder bit for bit at every case of MXU_CASES; the generator's build
    seconds and bytes; the int8 core (column-major generator, as kept, and
    row-major) and the same product in float32 (exact for 0/1 operands,
    timed once, not kept as a path); ``encode_to_symbols`` at P1 and P2 with
    both backends (CUDA events, host clock, profiler)."""
    from ldpc_3gpp_tpu_torch.models.encoder import encode_to_symbols
    from ldpc_3gpp_tpu_torch.ops import encoder as enc
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    cases = []
    for fields, rows in MXU_CASES:
        p = LDPCParams(**fields)
        enc.parity_generator_device.cache_clear()
        enc._parity_generator.cache_clear()
        t0 = time.perf_counter()
        gp = enc.parity_generator_device(p, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rng = np.random.default_rng(p.A)
        c = rng.integers(0, 2, (rows, p.C, p.K)).astype(np.int8)
        c[..., p.K_prime:] = 0
        c = torch.from_numpy(c).to(dev)
        if not torch.equal(enc.encode_mxu(p, c), enc.encode(p, c)):
            raise AssertionError(f"encode_mxu differs from 'rolls' on the card: {fields}")
        cases.append(dict(BG=p.BG, A=p.A, Z=p.Z_c, C=p.C, rows=rows * p.C,
                          generator_shape=list(gp.shape),
                          generator_bytes=gp.numel(), build_s=build_s))

    p = LDPCParams(**FLAGSHIP)
    gp = enc.parity_generator_device(p, dev)
    x = torch.randint(0, 2, (MAIN_BATCH, gp.shape[0]), dtype=torch.int8, device=dev)
    row_major = gp.contiguous()
    xf, gf = x.float(), gp.float()
    if not torch.equal((xf @ gf).to(torch.int32), torch._int_mm(x, gp)):
        raise AssertionError("float32 and int8 products differ at the flagship")
    core = dict(
        shape=[MAIN_BATCH, gp.shape[0], gp.shape[1]],
        int8_column_major_ms=time_ms(lambda: torch._int_mm(x, gp), 10),
        int8_row_major_ms=time_ms(lambda: torch._int_mm(x, row_major), 10),
        float32_ms=time_ms(lambda: xf @ gf, 5),
        operations=2 * MAIN_BATCH * gp.shape[0] * gp.shape[1],
    )
    del row_major, xf, gf

    symbols = {}
    for name, fields in (("P1", FLAGSHIP), ("P2", P2_FIELDS)):
        p = LDPCParams(**fields)
        a = torch.randint(0, 2, (MAIN_BATCH, p.A), dtype=torch.int8, device=dev)
        want = encode_to_symbols(p, a, "QPSK")
        row = {}
        for backend in ("rolls", "mxu"):
            def call():
                return encode_to_symbols(p, a, "QPSK", backend=backend)

            if not torch.equal(call(), want):
                raise AssertionError(f"encode_to_symbols '{backend}' differs at {name}")
            event_ms = time_ms(call, 10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / 10 * 1e3
            prof = profile_steps(call, 3, host_ms)
            row[backend] = dict(
                event_ms=event_ms, host_ms=host_ms,
                device_kernels_per_call=prof.get("kernels_per_step"),
                device_busy_ms=prof["device_busy_ms_per_step"], top=prof["top"])
        symbols[name] = dict(fields, C=p.C, Z=p.Z_c, blocks=MAIN_BATCH, **row)
    return dict(cases=cases, core=core, encode_to_symbols=symbols)


# The reference decoder held to itself on the CPU (tolerance 0) and to the
# flooding kernel: (fields, codewords, Es/N0 in dB; ET budget, run-to-budget
# budget).  At Z=208 sum-product is cut to budgets of 2 and 1 sweeps: the
# plain phi recipe on the host takes about 10 s per sweep of 256 codewords
# there (Z=20 runs it to a mix of early stops).
REFERENCE_CASES = (
    (dict(BG=2, A=100, G=300, Q_m=2), 64, 1.0, 10, 6),  # Z=20
    (dict(BG=2, A=2048, G=6144, Q_m=2), 256, 4.5, 8, 2),  # Z=208
)
REFERENCE_SP_BUDGET_Z208 = (2, 1)


def phase_reference_decoder(dev):
    """Backend 'reference' (the segment-op oracle) on the card equals the
    same decoder on the CPU, bits, parity flags and iteration counts, for
    the three rules with early termination and run to budget, and equals the
    flooding kernel on the same card inputs; its time beside the kernel's."""
    from ldpc_3gpp_tpu_torch.ops import decoder as ref
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.spec.params import LDPCParams

    out = []
    for fields, n, esn0_db, et_budget, run_budget in REFERENCE_CASES:
        p = LDPCParams(**fields)
        d, _ = noisy_d_tilde(p, "QPSK", esn0_db, n, 11, dev)
        llr = codeword_llrs(p, d[:, 0])
        llr_cpu = llr.cpu()
        for algorithm in ("min-sum", "offset-min-sum", "sum-product"):
            budgets = (et_budget, run_budget)
            if algorithm == "sum-product" and p.Z_c >= 208:
                budgets = REFERENCE_SP_BUDGET_Z208
            for early, iterations in zip((True, False), budgets):
                kw = dict(iterations=iterations, algorithm=algorithm,
                          early_termination=early)
                on_gpu = ref.decode(p, llr, **kw)
                on_cpu = ref.decode(p, llr_cpu, **kw)
                require_equal(type(on_gpu)(*(t.cpu() for t in on_gpu)), on_cpu,
                              ("cpu", kw))
                kernel = decoder_cuda.decode(p, llr, schedule="flooding", **kw)
                require_equal(kernel, on_gpu, ("kernel", kw))
                out.append(dict(Z=p.Z_c, codewords=n, **kw,
                                mean_iterations=float(on_gpu.iterations.float().mean()),
                                parity_ok=int(on_gpu.parity_ok.sum())))
    fields, n, esn0_db, et_budget, _ = REFERENCE_CASES[1]
    p = LDPCParams(**fields)
    d, _ = noisy_d_tilde(p, "QPSK", esn0_db, n, 12, dev)
    llr = codeword_llrs(p, d[:, 0])
    kw = dict(iterations=et_budget, algorithm="sum-product")
    timing = dict(Z=p.Z_c, codewords=n, **kw,
                  reference_ms=time_ms(lambda: ref.decode(p, llr, **kw), 3, warmup=1),
                  kernel_ms=time_ms(lambda: decoder_cuda.decode(
                      p, llr, schedule="flooding", **kw), 5))
    return dict(cases=out, max_abs_diff=0, tolerance=0, time=timing)


def phase_entry_points(dev, tmp):
    """The console commands and the API, in-process on the card, writing
    into ``tmp``: ``bler_sweep_main`` (with its plots where matplotlib is
    installed), ``snr_vs_a_main``, ``testbench_main`` encode and ``--decode``
    against the C++ oracle (launch counts set to 0 before, read after: the
    decode must run the flooding kernels), ``plot_results_main``, and an
    API round trip (HARQ over two redundancy versions) whose decoder on the
    card equals the same decoder with ``device='cpu'`` on the same LLRs."""
    import contextlib
    import importlib.util
    import io

    from ldpc_3gpp_tpu_torch import api, cli
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    plots = importlib.util.find_spec("matplotlib") is not None
    watch = Stopwatch()
    rec = {"matplotlib": plots}

    def run(main, argv):
        buf = io.StringIO()
        decoder_cuda.reset_launches()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return buf.getvalue(), dict(decoder_cuda.LAUNCHES)

    sweep_dir = os.path.join(tmp, "sweep")
    argv = ["--A", "100", "--rate", "0.5", "--algorithm", "min-sum",
            "--iterations", "8", "--target-block-errors", "50",
            "--target-bler", "1e-2", "--batch-per-device", "2048",
            "--results-dir", sweep_dir]
    text, launches = run(cli.bler_sweep_main,
                         argv + (["--live-plot"] if plots else ["--no-plot"]))
    with open(os.path.join(sweep_dir, "BLER_vs_SNR_100_0.5_2_QPSK_8_50_0_0.txt")) as f:
        points = [tuple(float(v) for v in ln.split()) for ln in f if not ln.startswith("#")]
    blers = [b for _, b in points]
    if not points or blers[-1] > 1e-2 or blers != sorted(blers, reverse=True):
        raise AssertionError(f"bler_sweep_main: not a falling waterfall: {points}")
    pngs = sorted(f for f in os.listdir(sweep_dir) if f.endswith(".png"))
    if plots and pngs != ["BLER_vs_SNR.png", "BLER_vs_SNR_live.png"]:
        raise AssertionError(f"bler_sweep_main wrote {pngs}")
    rec["bler_sweep"] = dict(points=points, pngs=pngs, launches=launches,
                             seconds=watch.lap())

    snr_dir = os.path.join(tmp, "snr")
    text, launches = run(cli.snr_vs_a_main, [
        "--A", "500", "--iterations", "8", "--target-block-errors", "30",
        "--target-bler", "1e-1", "--esn0-start", "-1.0", "--esn0-delta", "0.25",
        "--batch-per-device", "1024", "--no-plot", "--results-dir", snr_dir])
    with open(os.path.join(snr_dir, "SNR_vs_A_0.1_0.333333_1_QPSK_8_30_0.txt")) as f:
        required = f.read().split()
    if len(required) != 2 or required[0] != "500":
        raise AssertionError(f"snr_vs_a_main wrote {required}")
    rec["snr_vs_a"] = dict(A=500, required_esn0_db=float(required[1]),
                           launches=launches, seconds=watch.lap())

    text, launches = run(cli.testbench_main, ["--trials", "50", "--seed", "7"])
    ok = text.count("] ok ")
    if "MISMATCH" in text or f"{ok}/50 configs bit-exact" not in text or ok < 15:
        raise AssertionError(f"testbench encode: {text[-2000:]}")
    rec["testbench_encode"] = dict(trials=50, configs_checked=ok, mismatches=0,
                                   seconds=watch.lap())

    text, launches = run(cli.testbench_main,
                         ["--trials", "12", "--decode", "--max-a", "4000", "--seed", "7"])
    ok = text.count("] ok decode")
    if "MISMATCH" in text or ok < 8 or f"{ok}/12 configs bit-exact" not in text:
        raise AssertionError(f"testbench --decode: {text[-2000:]}")
    if launches["ldpc_flooding"] < 1:
        raise AssertionError(f"testbench --decode ran no flooding kernel: {launches}")
    rec["testbench_decode"] = dict(
        trials=12, configs_checked=ok, mismatches=0,
        rules=sorted({r for r in ("min-sum", "offset-min-sum", "sum-product")
                      if f" {r} it=" in text}),
        flooding_launches=launches["ldpc_flooding"], launches=launches,
        seconds=watch.lap())

    if plots:
        files = [os.path.join(sweep_dir, f) for f in os.listdir(sweep_dir)
                 if f.endswith(".txt")]
        out = os.path.join(tmp, "overlay.png")
        run(cli.plot_results_main, files + ["--out", out])
        if not os.path.exists(out):
            raise AssertionError("plot_results_main wrote no PNG")
        rec["plot_results"] = dict(png=True, seconds=watch.lap())
    else:
        rec["plot_results"] = "not run: matplotlib is not installed on this machine"

    kw = dict(BG=2, A=100, G=300, Q_m=2)
    dkw = dict(kw, I_HARQ=1, iterations=8)  # the default decoder: sum-product
    enc = api.NRLDPCEncoder(**kw)
    mod = api.NRModulator("QPSK")
    chan = api.AWGNChannel(snr_db=-0.5, seed=3)
    dem = api.NRDemodulator("QPSK", variance=10 ** 0.05)
    dec, dec_cpu = api.NRLDPCDecoder(**dkw), api.NRLDPCDecoder(**dkw, device="cpu")
    enc_cpu = api.NRLDPCEncoder(**kw, device="cpu")
    mod_cpu = api.NRModulator("QPSK", device="cpu")
    rng = np.random.default_rng(8)
    decoder_cuda.reset_launches()
    steps = []
    for trial in range(2):
        a = rng.integers(0, 2, (16, kw["A"])).astype(np.int8)
        dec.reset()
        dec_cpu.reset()
        for rv in (0, 2):
            for obj in (enc, enc_cpu, dec, dec_cpu):
                obj.rv_id = rv
            g = enc.step(a)
            tx = mod.step(g)
            if not (np.array_equal(g, enc_cpu.step(a))
                    and np.array_equal(tx, mod_cpu.step(g))):
                raise AssertionError("API encoder or modulator: card differs from CPU")
            llr = dem.step(chan.step(tx))
            (a_gpu, ok_gpu), (a_cpu, ok_cpu) = dec.step(llr), dec_cpu.step(llr)
            if not (np.array_equal(a_gpu, a_cpu) and np.array_equal(ok_gpu, ok_cpu)):
                raise AssertionError("API decoder: card differs from CPU")
            steps.append(int(ok_gpu.sum()))
    rec["api_round_trip"] = dict(
        config="BG2 A=100 G=300 QPSK, default decoder, HARQ rv (0, 2), "
        "16 blocks, 2 trials", esn0_db=-0.5, tb_ok_by_step=steps,
        launches=dict(decoder_cuda.LAUNCHES), seconds=watch.lap())
    if decoder_cuda.LAUNCHES["ldpc_flooding"] < 1 or steps[1] <= steps[0]:
        raise AssertionError(f"API round trip: {rec['api_round_trip']}")
    return rec


DIST_SEED = 17
# (b): blocks per rank and call of the two ranks on the one card
DIST_BATCH = 256
# the ranks of (b) and (c) are joined under this timeout, then killed
DIST_TIMEOUT_S = 300
DIST_WORKER = r"""
import json, sys, time
import torch
import torch.distributed as dist
from ldpc_3gpp_tpu_torch.parallel.launcher import init_distributed
assert init_distributed(backend="gloo", timeout_s=240)
sys.path.insert(0, sys.argv[1])
import chip_smoke
from ldpc_3gpp_tpu_torch.ops import decoder_cuda
from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
from ldpc_3gpp_tpu_torch.utils.rng import make_generator
seed, batch, esn0 = int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4])
mc = MonteCarlo(chip_smoke.flagship_config(), batch_per_device=batch, device="cuda")
torch.cuda.synchronize()
decoder_cuda.reset_launches()
c = mc.run(make_generator(seed, "cuda"), esn0)
torch.cuda.synchronize()
launches = dict(decoder_cuda.LAUNCHES)
ms = []
for _ in range(3):
    t0 = time.perf_counter()
    mc.run(make_generator(seed + 1, "cuda"), esn0)
    ms.append((time.perf_counter() - t0) * 1e3)
print("RESULT " + json.dumps(dict(
    rank=dist.get_rank(), world=mc.world_size, backend=dist.get_backend(),
    device=str(torch.cuda.current_device()), blocks_per_run=mc.blocks_per_run,
    counters=dict(c, iteration_hist=c["iteration_hist"].tolist()),
    launches=launches, call_ms=ms)), flush=True)
dist.destroy_process_group()
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plain_counters(c):
    return dict(c, iteration_hist=[int(v) for v in c["iteration_hist"]])


def call_ms(mc, seed, esn0_db, dev):
    """Host-clock milliseconds of one ``MonteCarlo.run`` (it ends in its
    host fetch)."""
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    generator = make_generator(seed, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc.run(generator, esn0_db)
    return (time.perf_counter() - t0) * 1e3


def phase_distributed(dev):
    """The multi-process path on the one card.

    (a) World size 1 under NCCL, in this process (``init_distributed`` with a
    free local port): ``MonteCarlo`` at P1 (1,024 blocks, 2 steps, 1.0 dB)
    gives the counters of the same seed without a group, bit for bit, through
    V1; the call's host-clock ms with the all-reduce, between calls without
    it made before the group and after it.
    (b) Two ranks on the card under gloo (NCCL refuses two ranks on one
    device), started through the launcher: both print the same counters,
    equal to the sum of this process's single-process runs seeded
    ``rank_seed(seed, 0)`` and ``rank_seed(seed, 1)``.  (c)
    ``dryrun_multichip(2, device="cuda")``, whose ranks must launch both the
    flooding and the layered kernel, and ``entry()`` once."""
    import torch.distributed as dist

    from ldpc_3gpp_tpu_torch.entry import dryrun_multichip, entry
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.parallel.launcher import in_group, init_distributed
    from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    watch = Stopwatch()
    cfg = flagship_config()
    out = {}

    # (a) MonteCarlo sums over the default group whenever one exists, so the
    # calls without a group are timed before it is made and after it is gone
    mc = MonteCarlo(cfg, batch_per_device=MAIN_BATCH, steps_per_call=MAIN_STEPS, device=dev)
    want = plain_counters(mc.run(make_generator(DIST_SEED, dev), MAIN_ESN0_DB))
    times = {"no_group": [call_ms(mc, DIST_SEED + 1, MAIN_ESN0_DB, dev) for _ in range(2)],
             "nccl_world_1": []}
    assert init_distributed(coordinator_address=f"127.0.0.1:{free_port()}",
                            num_processes=1, process_id=0, timeout_s=300)
    try:
        backend = dist.get_backend()
        grouped = in_group()
        torch.cuda.synchronize()
        decoder_cuda.reset_launches()
        got = plain_counters(mc.run(make_generator(DIST_SEED, dev), MAIN_ESN0_DB))
        torch.cuda.synchronize()
        launches = dict(decoder_cuda.LAUNCHES)
        times["nccl_world_1"] = [call_ms(mc, DIST_SEED + 1, MAIN_ESN0_DB, dev)
                                 for _ in range(4)]
    finally:
        dist.destroy_process_group()
    times["no_group"] += [call_ms(mc, DIST_SEED + 1, MAIN_ESN0_DB, dev) for _ in range(2)]
    out["world_1_nccl"] = dict(
        backend=backend, config="P1: BG1 A=8424 Z=384 QPSK layered min-sum 12 it",
        batch=MAIN_BATCH, steps_per_call=MAIN_STEPS, esn0_db=MAIN_ESN0_DB,
        counters=got, equal_to_no_group=got == want, launches=launches,
        call_ms=times, seconds=watch.lap())
    if backend != "nccl" or got != want or not grouped:
        raise AssertionError(f"world size 1 under NCCL: {out['world_1_nccl']}, no group {want}")
    expect_launches(launches, "ldpc_layered", MAIN_STEPS)

    # (b)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ldpc_3gpp_tpu_torch.parallel.launcher",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank), "--", sys.executable, "-c", DIST_WORKER, ROOT,
         str(DIST_SEED), str(DIST_BATCH), str(MAIN_ESN0_DB)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for rank in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if any(proc.returncode != 0 for proc in procs):
        raise AssertionError(f"two ranks under gloo: a rank failed: {logs}")
    ranks = [json.loads(next(ln for ln in log.splitlines() if ln.startswith("RESULT "))[7:])
             for log in logs]
    singles = []
    for rank in range(2):
        mc = MonteCarlo(cfg, batch_per_device=DIST_BATCH, device=dev)
        singles.append(plain_counters(mc.run(make_generator(DIST_SEED, dev, rank=rank),
                                             MAIN_ESN0_DB)))
    summed = {k: ([a + b for a, b in zip(singles[0][k], singles[1][k])]
                  if k == "iteration_hist" else singles[0][k] + singles[1][k])
              for k in singles[0]}
    out["two_ranks_gloo"] = dict(
        config="P1 with 256 blocks per rank", ranks=ranks, single_process_sum=summed,
        seconds=watch.lap())
    if (ranks[0]["counters"] != ranks[1]["counters"] or ranks[0]["counters"] != summed
            or {r["backend"] for r in ranks} != {"gloo"} or ranks[0]["world"] != 2
            or ranks[0]["blocks_per_run"] != 2 * DIST_BATCH
            or any(r["launches"]["ldpc_layered"] != 1 for r in ranks)):
        raise AssertionError(f"two ranks under gloo: {out['two_ranks_gloo']}")

    # (c)
    records = dryrun_multichip(2, device="cuda", timeout_s=DIST_TIMEOUT_S)
    torch.cuda.synchronize()
    decoder_cuda.reset_launches()
    fn, example_args = entry()
    counters = [int(t) for t in fn(*example_args)]
    torch.cuda.synchronize()
    out["dryrun_multichip"] = dict(
        counters=records[0]["counters"], launches_by_rank=[r["launches"] for r in records],
        entry=dict(counters=counters, launches=dict(decoder_cuda.LAUNCHES)),
        seconds=watch.lap())
    if (any(r["launches"]["ldpc_flooding"] < 1 or r["launches"]["ldpc_layered"] < 1
            for r in records)
            or counters[0] != 8 or decoder_cuda.LAUNCHES["ldpc_flooding"] != 1):
        raise AssertionError(f"dryrun_multichip / entry: {out['dryrun_multichip']}")
    return out


# The bulk goldens (made by the JAX package's tools/bulk_montecarlo.py on a
# TPU); each run is sized for about BULK_EXPECTED_ERRORS block errors at the
# golden's rate, in four calls.
BULK_GOLDENS = ("bulk_montecarlo.json", "bulk_sp_montecarlo.json",
                "bulk_lbrm_montecarlo.json", "bulk_cbgti_montecarlo.json")
BULK_EXPECTED_ERRORS = 150
BULK_BATCH = 512
# a bulk run sized for its errors alone may take a fraction of a second,
# which launch and fetch overheads dominate: its TB/s is read from a second
# run of at least this many seconds
BULK_MIN_WINDOW_S = 3.0
# two campaign entries (golden/pod_campaign.json), each at a scale that
# keeps it to about 20 s on the card: name -> scale
CAMPAIGN_ENTRIES = {"bg1_a8424_r13_qpsk": 0.01, "bg2_a100_r12_qpsk": 0.01}


def bulk_argv(config, blocks, batch, steps, out):
    """The bulk tool's arguments for a golden's ``config`` block."""
    argv = ["--blocks", str(blocks), "--A", str(config["A"]),
            "--rate", repr(config["A"] / config["G"]), "--bg", str(config["BG"]),
            "--modulation", config["modulation"], "--esn0", repr(config["esn0_db"]),
            "--iterations", str(config["iterations"]), "--algorithm", config["algorithm"],
            "--schedule", config["schedule"], "--batch-per-device", str(batch),
            "--steps-per-call", str(steps), "--out", out]
    for flag, key in (("--N-L", "N_L"), ("--I-LBRM", "I_LBRM"), ("--TBS-LBRM", "TBS_LBRM")):
        if config.get(key) is not None:
            argv += [flag, str(config[key])]
    if config.get("CBGTI"):
        argv += ["--CBGTI", *map(str, config["CBGTI"])]
    if config.get("rv_sequence"):
        argv += ["--rv-sequence", *map(str, config["rv_sequence"])]
    if config.get("cbgti_sequence") is not None:
        argv += ["--cbgti-seq", json.dumps(config["cbgti_sequence"])]
    return argv


def quiet(main, argv):
    """``main(argv)`` with its printing kept out of this script's output;
    returns (its result, {kernel: launches}, seconds)."""
    import contextlib
    import io

    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    torch.cuda.synchronize()
    decoder_cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = main(argv)
    torch.cuda.synchronize()
    return result, dict(decoder_cuda.LAUNCHES), time.perf_counter() - t0


def throughput_window(main, config, first, batch, steps, path):
    """TB/s and Mbit/s of the bulk tool at ``config`` over a window of at
    least ``BULK_MIN_WINDOW_S``: ``first``'s own where its window was as long,
    else those of a later run at the same call shape sized from the last
    run's rate (at most three; its counters returned too, for the gate)."""
    result, launches, runs = first, None, 0
    while result["elapsed_s"] < BULK_MIN_WINDOW_S and runs < 3:
        blocks = math.ceil(1.5 * BULK_MIN_WINDOW_S * result["transport_blocks_per_sec"])
        result, launches, _ = quiet(main, bulk_argv(config, blocks, batch, steps, path))
        runs += 1
    rec = dict(blocks=result["blocks"], elapsed_s=result["elapsed_s"],
               transport_blocks_per_sec=result["transport_blocks_per_sec"],
               info_mbps=result["info_mbps"], later_runs=runs)
    if runs:
        rec.update(block_errors=result["block_errors"], bler=result["bler"],
                   launches=launches)
    return rec


def phase_campaign(tmp):
    """The campaign tools on the card, writing into ``tmp``.

    The bulk tool at the four bulk goldens' configurations (read from each
    golden's ``config`` block): blocks, errors, launches by kernel, the BLER
    inside ``two_sample_gate`` of the golden's, and TB/s and Mbit/s over a
    window of at least ``BULK_MIN_WINDOW_S`` (``throughput_window``); at the
    first configuration also with the sweeps' shallow calls (256 x 1) for
    the throughput of deep calls.  ``pod_campaign`` at two entries of
    golden/pod_campaign.json: each calibrated Es/N0 beside the golden's, the
    BLER gated where the two are equal, V1 launched."""
    from ldpc_3gpp_tpu_torch.tools import bulk_montecarlo, pod_campaign

    out = {"bulk": [], "campaign": []}
    for name in BULK_GOLDENS:
        with open(os.path.join(ROOT, "golden", name)) as f:
            golden = json.load(f)
        config = golden["config"]
        blocks = math.ceil(BULK_EXPECTED_ERRORS / golden["bler"])
        steps = max(1, math.ceil(blocks / BULK_BATCH / 4))
        path = os.path.join(tmp, name)
        result, launches, seconds = quiet(
            bulk_montecarlo.main, bulk_argv(config, blocks, BULK_BATCH, steps, path))
        with open(path) as f:
            if json.load(f) != json.loads(json.dumps(result)):
                raise AssertionError(f"{name}: the written JSON differs from the result")
        for key in ("G", "N_cb", "N"):
            if key in config and result["config"][key] != config[key]:
                raise AssertionError(f"{name}: {key} {result['config'][key]} != {config[key]}")
        rec = dict(golden=name, config=result["config"], blocks=result["blocks"],
                   block_errors=result["block_errors"], bler=result["bler"],
                   mean_iterations_per_cb=result["mean_iterations_per_cb"],
                   transport_blocks_per_sec=result["transport_blocks_per_sec"],
                   info_mbps=result["info_mbps"], elapsed_s=result["elapsed_s"],
                   call=[BULK_BATCH, steps], launches=launches, seconds=seconds,
                   golden_tpu_transport_blocks_per_sec=golden["transport_blocks_per_sec"],
                   golden_tpu_info_mbps=golden["info_mbps"],
                   gate=two_sample_gate(name, config["esn0_db"], result["blocks"],
                                        result["block_errors"], golden["blocks"],
                                        golden["block_errors"]))
        rec["throughput"] = throughput_window(bulk_montecarlo.main, config, result,
                                              BULK_BATCH, steps, path)
        if rec["throughput"]["later_runs"]:
            rec["throughput"]["gate"] = two_sample_gate(
                name, config["esn0_db"], rec["throughput"]["blocks"],
                rec["throughput"]["block_errors"], golden["blocks"], golden["block_errors"])
        if name == BULK_GOLDENS[0]:
            path = os.path.join(tmp, "shallow.json")
            shallow, _, _ = quiet(bulk_montecarlo.main, bulk_argv(config, 20_480, 256, 1, path))
            rec["shallow_calls_256x1"] = throughput_window(
                bulk_montecarlo.main, config, shallow, 256, 1, path)
        out["bulk"].append(rec)

    with open(os.path.join(ROOT, "golden", "pod_campaign.json")) as f:
        golden = json.load(f)["configs"]
    v1 = 0
    for entry, scale in CAMPAIGN_ENTRIES.items():
        path = os.path.join(tmp, f"campaign_{entry}.json")
        result, launches, seconds = quiet(
            pod_campaign.main, ["--only", entry, "--scale", repr(scale), "--out", path])
        got, want = result["configs"][entry], golden[entry]
        rec = dict(entry=entry, scale=scale, esn0_db=got["esn0_db"],
                   golden_esn0_db=want["esn0_db"], blocks=got["blocks"],
                   block_errors=got["block_errors"], bler=got["bler"],
                   golden_bler=want["bler"],
                   transport_blocks_per_sec=got["transport_blocks_per_sec"],
                   info_mbps=got["info_mbps"], elapsed_s=got["elapsed_s"],
                   launches=launches, seconds=seconds)
        if got["esn0_db"] == want["esn0_db"]:
            rec["gate"] = two_sample_gate(entry, got["esn0_db"], got["blocks"],
                                          got["block_errors"], want["blocks"],
                                          want["block_errors"])
        v1 += launches["ldpc_layered"]
        out["campaign"].append(rec)
    if v1 < 1:
        raise AssertionError(f"the campaign launched no layered kernel: {out['campaign']}")
    return out


# The golden pipeline's points (phase `goldens`).  DE: samples per edge of the
# reg36 bisection and of the two BG1 verdicts, and the margin of the verdicts
# around the golden thresholds.
GOLDENS_DE_SAMPLES = 20_000
GOLDENS_DE_MARGIN_DB = 0.1
# (artifact, curve, Es/N0, protocol of the point, error target of this run:
# cut where the golden's needs more blocks than the phase's budget)
GOLDENS_POINTS = (
    ("BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json", "SP-flooding", 0.75, "SPVSMS", 100),
    ("BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json", "NMS-flooding", 1.0, "SPVSMS", 100),
    ("BLER_SP_vs_MS_BG2_A3842_R13_QPSK_8it.json", "NMS-layered-pallas", 0.0, "SPVSMS", 30),
    ("config2_and_harq.json", "harq_single_shot_rv0", 4.5, "CONFIG2", 100),
    ("config2_and_harq.json", "harq_single_shot_rv0", 5.0, "CONFIG2", 100),
    ("config2_and_harq.json", "harq_harq_ir_rv0231", 0.0, "CONFIG2", 3),
    ("demod_methods_64QAM.json", "exact", 10.75, "DEMOD", 100),
    ("demod_methods_64QAM.json", "exact", 11.0, "DEMOD", 100),
    ("demod_methods_64QAM.json", "maxlog", 10.75, "DEMOD", 100),
    ("demod_methods_64QAM.json", "maxlog", 11.0, "DEMOD", 100),
)
# golden/demod_methods_64QAM.json predates the JAX package's reversed layered
# row order (its commit e1165b4 against ed70883, which re-measured every other
# layered golden), so its waterfall sits ~0.2 dB late.  The demod points are
# held instead against the JAX package of today on the CPU at the golden's
# protocol (runs of 256 blocks from jax.random.PRNGKey(1): 8 on the waterfall,
# at 11.0 dB until 100 block errors; re-measured by
# tests/test_torch_goldens.py::test_jax_package_today_on_the_demod_link):
# (method, Es/N0) -> (blocks, block errors)
DEMOD_JAX_TODAY = {("exact", 10.5): (2048, 1278), ("exact", 10.75): (2048, 232),
                   ("exact", 11.0): (34560, 100),
                   ("maxlog", 10.5): (2048, 1312), ("maxlog", 10.75): (2048, 243),
                   ("maxlog", 11.0): (29696, 100)}
# the surface row no other phase covers; its sweep starts this far below the
# golden's lowest required Es/N0 at 1e-1, on the protocol's 0.1 dB grid
GOLDENS_SURFACE_ROW = ("min-sum", "0.666667", 2 / 3)
GOLDENS_SURFACE_LEAD_DB = 0.4
# the config1 stage runs the flooding kernel (backend 'auto'), the JAX stage
# its plain decoder: one call of the stage's protocol at this point of its
# sweep through both, counters equal
GOLDENS_CONFIG1_ESN0_DB = 2.5


def golden_point_config(artifact, curve, protocol):
    """(ChainConfig, batch, steps, the golden's (blocks, errors) rule) of a
    golden curve, from the port's protocol constants."""
    from ldpc_3gpp_tpu_torch.parallel.sweep import _make_config
    from ldpc_3gpp_tpu_torch.tools import demod_compare, regen_goldens

    if protocol == "SPVSMS":
        p = regen_goldens.SPVSMS
        (_, algorithm, schedule), = [c for c in p["curves"] if c[0] == curve]
        cfg = _make_config(p["A"], p["rate"], p["bg"], p["modulation"], (0,),
                           p["iterations"], algorithm, schedule=schedule)
        # bler_vs_snr's default max_blocks_per_point capped each point
        return cfg, p["batch_per_device"], p["steps_per_call"], (p["target_block_errors"],
                                                                  1_000_000)
    if protocol == "CONFIG2":
        p = regen_goldens.CONFIG2["harq"]
        (_, rv, _, tbe), = [c for c in p["curves"] if c[0] == curve]
        cfg = _make_config(p["A"], p["rate"], p["bg"], p["modulation"], rv,
                           p["iterations"], p["algorithm"], schedule=p["schedule"])
        return cfg, p["batch_per_device"], p["steps_per_call"], (tbe, p["max_blocks"])
    p = demod_compare.PROTOCOL
    cfg = _make_config(p["A"], p["rate"], p["bg"], p["modulation"], (0,), p["iterations"],
                       p["algorithm"], schedule=p["schedule"], demod_method=curve)
    return cfg, p["batch_per_device"], p["steps_per_call"], (p["target_block_errors"], None)


def phase_goldens(dev, tmp):
    """The golden pipeline's tools on the card, held against the JAX goldens.

    Density evolution: reg36 bisected at ``GOLDENS_DE_SAMPLES`` samples to
    within 0.05 dB of the published sigma 0.8809; bg1_r13 and bg1_r13_nms
    converge at their golden threshold + 0.1 dB and fail at - 0.1 dB.  BLER
    points of the headline/spvsms, config2 (HARQ IR and single shot) and
    demod-comparison protocols, each inside the two-sample bound of its golden
    (error targets cut where listed; the demod points of the JAX package today,
    ``DEMOD_JAX_TODAY``: its golden predates the reversed layered row order).  The surface row ``GOLDENS_SURFACE_ROW``
    through the ``surface`` stage: every required Es/N0 within
    ``SNR_VS_A_TOLERANCE_DB`` of golden/SNR_vs_A_surface.json, its gap to the
    normal-approximation bound positive.  One call of the config1 stage's
    protocol through the plain 'fast' decoder and through the stage's
    backend (the flooding kernel): the same counters.  The plots where
    matplotlib is installed; whether the committed artifacts' stamps are
    current."""
    import importlib.util

    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.parallel.montecarlo import MonteCarlo
    from ldpc_3gpp_tpu_torch.parallel.sweep import _simulate_point
    from ldpc_3gpp_tpu_torch.tools import density_evolution as de
    from ldpc_3gpp_tpu_torch.tools import na_bound, regen_goldens
    from ldpc_3gpp_tpu_torch.utils.artifacts import infer_counts
    from ldpc_3gpp_tpu_torch.utils.fingerprint import semantics_fingerprint
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    def golden(name):
        with open(os.path.join(ROOT, "golden", name)) as f:
            return json.load(f)

    out = {}
    torch.cuda.synchronize()
    decoder_cuda.reset_launches()
    watch = Stopwatch()

    # density evolution
    thresholds = golden("de_thresholds.json")["rows"]
    ens, _ = de._make_ensemble("reg36")
    thr, res = de.find_threshold(ens, S=GOLDENS_DE_SAMPLES, start_db=de.CONFIGS["reg36"],
                                 verbose=False, device=dev)
    sigma = de.sigma_from_esn0(thr)
    delta_db = 20 * math.log10(de.REG36_PUBLISHED_SIGMA / sigma)
    verdicts = {}
    for name in ("bg1_r13", "bg1_r13_nms"):
        evolver = de.Evolver(de._make_ensemble(name)[0], GOLDENS_DE_SAMPLES, dev)
        t = thresholds[name]["threshold_esn0_db"]
        verdicts[name] = {
            f"{db:+.3f}": de.converges(evolver, de.m_of(db), 600, 1e-4, 0)[0]
            for db in (t + GOLDENS_DE_MARGIN_DB, t - GOLDENS_DE_MARGIN_DB)}
    out["density_evolution"] = dict(
        samples=GOLDENS_DE_SAMPLES, reg36_threshold_sigma=sigma, reg36_delta_db=delta_db,
        reg36_resolution_db=res, verdicts_at_golden_plus_minus_0_1_db=verdicts,
        seconds=watch.lap())
    if abs(delta_db) > 0.05 or any(list(v.values()) != [True, False] for v in verdicts.values()):
        raise AssertionError(f"density evolution off its goldens: {out['density_evolution']}")

    # BLER points against the goldens
    points = []
    for artifact, curve, esn0, protocol, errors_target in GOLDENS_POINTS:
        cfg, batch, steps, rule = golden_point_config(artifact, curve, protocol)
        if protocol == "DEMOD":
            g_blocks, g_errors = DEMOD_JAX_TODAY[curve, esn0]
        else:
            g = golden(artifact)[curve]
            i = g["esn0_db"].index(esn0)
            g_blocks, g_errors = infer_counts(g["bler"][i], batch * steps, *rule)
        mc = MonteCarlo(cfg, batch_per_device=batch, steps_per_call=steps, device=dev)
        pt, _ = _simulate_point(mc, make_generator(0, dev), esn0, errors_target, True,
                                2_000_000)
        rec = two_sample_gate(f"{artifact}/{curve}", esn0, pt.blocks, pt.block_errors,
                              g_blocks, g_errors)
        rec["error_target"] = errors_target
        if protocol == "DEMOD":
            rec["reference"] = "the JAX package today on the CPU (DEMOD_JAX_TODAY)"
        elif errors_target < rule[0]:
            rec["cut"] = f"error target {errors_target} (the protocol's {rule[0]})"
        points.append(rec)
    out["points"] = points
    out["points_seconds"] = watch.lap()

    # config #1's stage on the kernel: one call of its protocol through the
    # plain 'fast' decoder and through 'auto' on the same stream
    from ldpc_3gpp_tpu_torch.parallel.sweep import _make_config

    c1 = regen_goldens.CONFIG1
    counters = {}
    for backend in ("fast", regen_goldens.CONFIG1["backend"]):
        cfg = _make_config(c1["A"], c1["rate"], c1["bg"], c1["modulation"], (0,),
                           c1["iterations"], c1["algorithm"], backend=backend,
                           schedule=c1["schedule"])
        mc = MonteCarlo(cfg, batch_per_device=c1["batch_per_device"],
                        steps_per_call=c1["steps_per_call"], device=dev)
        before = decoder_cuda.LAUNCHES["ldpc_flooding"]
        c = mc.run(make_generator(c1["seed"], dev), GOLDENS_CONFIG1_ESN0_DB)
        counters[backend] = dict(plain_counters(c),
                                 flooding_launches=decoder_cuda.LAUNCHES["ldpc_flooding"] - before)
    fast, auto = counters["fast"], counters[c1["backend"]]
    out["config1_fast_vs_auto"] = dict(esn0_db=GOLDENS_CONFIG1_ESN0_DB, **counters,
                                       seconds=watch.lap())
    if ({k: v for k, v in fast.items() if k != "flooding_launches"}
            != {k: v for k, v in auto.items() if k != "flooding_launches"}
            or fast["flooding_launches"] != 0 or auto["flooding_launches"] < 1
            or c1["backend"] != "auto"):
        raise AssertionError(f"config1 on the kernel differs from 'fast': {counters}")

    # one surface row through the surface stage
    algorithm, r_key, rate = GOLDENS_SURFACE_ROW
    g_surface = golden("SNR_vs_A_surface.json")
    g_curve = g_surface["curves"][f"{algorithm}/{r_key}"]
    (_, _, proto_start), = [r for r in regen_goldens.SURFACE["rates"] if r[0] == r_key]
    step = regen_goldens.SURFACE["esn0_delta"]
    start = proto_start + step * math.floor(
        (min(g_curve["required_esn0_db_at_0.1"]) - GOLDENS_SURFACE_LEAD_DB - proto_start) / step)
    # the stage sets the counts to 0 itself: add back the phase's so far
    launches, by_p = dict(decoder_cuda.LAUNCHES), dict(decoder_cuda.LAUNCHES_BY_P)
    rec = regen_goldens.run_stage("surface", tmp, dev, tmp, algorithms=(algorithm,),
                                  rates=((r_key, rate, round(start, 6)),))
    for name, n in launches.items():
        decoder_cuda.LAUNCHES[name] += n
    for key, n in by_p.items():
        decoder_cuda.LAUNCHES_BY_P[key] = decoder_cuda.LAUNCHES_BY_P.get(key, 0) + n
    with open(os.path.join(tmp, "SNR_vs_A_surface.json")) as f:
        row = json.load(f)
    mine = row["curves"][f"{algorithm}/{r_key}"]
    at = [g_surface["A"].index(A) for A in row["A"]]
    worst = max(abs(a - g_curve[t][i]) for t in mine for a, i in zip(mine[t], at, strict=True))
    gaps = [m - na_bound.na_required_esn0_db(A, int(round(A / rate / 2) * 2), float(t[21:]))
            for t in mine for A, m in zip(row["A"], mine[t])]
    out["surface_row"] = dict(
        curve=f"{algorithm}/{r_key}", A=row["A"], start_esn0_db=round(start, 6),
        cut=f"sweep starts at {round(start, 6)} dB, not {proto_start} (the points "
            "below are at BLER 1)", required_esn0_db=mine, golden=g_curve,
        max_abs_diff_db=worst, tolerance_db=SNR_VS_A_TOLERANCE_DB, min_na_gap_db=min(gaps),
        blocks=rec["blocks"], seconds=rec["seconds"])
    if worst > SNR_VS_A_TOLERANCE_DB or min(gaps) <= 0:
        raise AssertionError(f"surface row outside its gate: {out['surface_row']}")

    if importlib.util.find_spec("matplotlib") is None:
        out["plots"] = "skipped: matplotlib is not installed here"
    else:
        import shutil

        from ldpc_3gpp_tpu_torch.tools import plot_snr_vs_a_surface, regen_plots

        art = shutil.copytree(os.path.join(ROOT, "golden_torch"), os.path.join(tmp, "art"))
        plots = regen_plots.main(["--dir", art])
        plot_snr_vs_a_surface.main(["--golden", os.path.join(tmp, "SNR_vs_A_surface.json"),
                                    "--out", os.path.join(plots, "surface_row.png")])
        out["plots"] = sorted(os.listdir(plots))

    current = semantics_fingerprint()
    stamps = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "golden_torch", "*.json"))):
        with open(path) as f:
            stamps[os.path.basename(path)] = json.load(f).get("semantics") == current
    out["stamps_current"] = stamps
    out["semantics"] = current
    torch.cuda.synchronize()
    out["launches"] = dict(decoder_cuda.LAUNCHES)
    out["launches_by_P"] = launches_by_p()
    out["cluster_launches"] = cluster_launches()
    if (out["launches"]["ldpc_layered"] < 1 or out["launches"]["ldpc_flooding"] < 1
            or out["cluster_launches"] < 1):
        raise AssertionError(f"the golden pipeline missed a kernel: {out['launches']}")
    return out


# The bench phase: the headline and every sweep row of the port's bench.py at
# a cut protocol (listed in the phase's line), the roofline's rows, and
# profile_sim's step profile at P1.  Mean iterations per TB within 15 % of
# both bench_sweep goldens (the JAX gate, tests/test_tpu_kernel.py:323-328),
# BLER inside the two-sample bound of the JAX row; TB/s not gated.
BENCH_HEADLINE_CUT = dict(trials=2, reps=1, scalar_seconds=0.5)
BENCH_SWEEP_CUT = dict(steps=16, trials=1, reps=1)
BENCH_ITERATION_TOLERANCE = 0.15
BENCH_ROOFLINE_REPS = 10


def phase_bench(dev, card):
    """The port's benchmark module and its measurement tools on the card,
    each part with the launch counts set to 0 before it and read after."""
    from ldpc_3gpp_tpu_torch import bench
    from ldpc_3gpp_tpu_torch.models.chain import simulate_batch
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.tools import op_rates, profile_sim, roofline
    from ldpc_3gpp_tpu_torch.utils.rng import make_generator

    def golden_rows(root):
        with open(os.path.join(ROOT, root, "bench_sweep.json")) as f:
            return {r["name"]: r for r in json.load(f)["rows"]}

    def launched(kernel):
        torch.cuda.synchronize()
        got = dict(decoder_cuda.LAUNCHES)
        if got[kernel] < 1 or any(n for k, n in got.items() if k != kernel):
            raise AssertionError(f"expected launches of {kernel} only, got {got}")
        return got

    out = {}
    watch = Stopwatch()
    torch.cuda.synchronize()
    decoder_cuda.reset_launches()
    line = bench._headline(device=dev, **BENCH_HEADLINE_CUT)
    d = line["detail"]
    out["headline"] = dict(
        cut=d["cut"], protocol=d["protocol"], transport_blocks_per_s=d["transport_blocks_per_sec"],
        median_transport_blocks_per_s=d["median_transport_blocks_per_sec"],
        decoded_info_mbit_per_s=line["value"], mean_iterations_per_tb=d["mean_iterations_per_tb"],
        block_errors=d["block_errors"], blocks=d["blocks"],
        scalar_cpu_codewords_per_s=d["scalar_cpu_codewords_per_sec"],
        vs_measured_scalar_cpu=line["vs_measured_scalar_cpu"],
        launches=launched("ldpc_layered"), launches_by_P=launches_by_p(), seconds=watch.lap())
    if d["block_errors"] > 2 or set(d["scalar_cpu_codewords_per_sec"]) != {
            "min-sum", "sum-product"}:
        raise AssertionError(f"bench headline: {out['headline']}")

    jax_rows, port_rows = golden_rows("golden"), golden_rows("golden_torch")
    rows = []
    for row in bench.sweep_rows():
        torch.cuda.synchronize()
        decoder_cuda.reset_launches()
        (r,) = bench.run_sweep(device=dev, names=[row["name"]], **BENCH_SWEEP_CUT)
        rec = dict(name=r["name"], tb_per_s=r["tb_per_sec"], info_mbit_per_s=r["info_mbps"],
                   mean_iterations_per_tb=r["mean_iterations_per_tb"], bler=r["bler"],
                   blocks=r["blocks"], codewords_per_block=r["seen"]["codewords_per_block"],
                   launches=launched(decoder_cuda.KERNEL_NAMES[row["cfg"].schedule]),
                   launches_by_P=launches_by_p())
        for ref, golden in (("jax", jax_rows), ("port", port_rows)):
            want = golden[r["name"]]["mean_iterations_per_tb"]
            rec[f"{ref}_mean_iterations_per_tb"] = want
            if abs(r["mean_iterations_per_tb"] - want) > BENCH_ITERATION_TOLERANCE * want:
                raise AssertionError(f"bench row {r['name']}: mean iterations "
                                     f"{r['mean_iterations_per_tb']} against {ref} {want}")
        g = jax_rows[r["name"]]
        rec["bler_gate"] = two_sample_gate(
            f"bench_sweep/{r['name']}", r["esn0_db"], r["blocks"],
            r["seen"]["block_errors"], g["blocks"], round(g["bler"] * g["blocks"]))
        rows.append(rec)
    out["sweep"] = dict(cut=BENCH_SWEEP_CUT, rows=rows, seconds=watch.lap())

    torch.cuda.synchronize()
    decoder_cuda.reset_launches()
    op_rates.reset_launches()
    lines, cache = [], {}
    for name, fields, iterations, esn0_db, schedule in roofline.ROWS:
        r = roofline.measure_row(name, fields, iterations, esn0_db, schedule, roofline.BATCH,
                                 dev, BENCH_ROOFLINE_REPS, cache, card)
        if r["launches"][decoder_cuda.KERNEL_NAMES[schedule]] < 1:
            raise AssertionError(f"roofline row {name} launched no {schedule} kernel")
        lines.append({k: r[k] for k in (
            "name", "us_per_codeword", "mean_sweeps", "operations_per_codeword", "bound_ms",
            "bound_by", "measured_rate_ms", "ms", "share_of_bound", "share_of_measured_rate",
            "codewords_per_block", "layout", "launches")})
    torch.cuda.synchronize()
    out["roofline"] = dict(rows=lines, op_rates_launches=op_rates.LAUNCHES[op_rates.KERNEL_NAME],
                           seconds=watch.lap())
    if out["roofline"]["op_rates_launches"] < 1:
        raise AssertionError("the roofline measured no op rate")

    cfg = flagship_config()
    generator = make_generator(3, dev)
    decoder_cuda.reset_launches()
    p1 = profile_sim.measure(
        "simulate_batch esn0=1 (P1)",
        lambda _: simulate_batch(cfg, generator, MAIN_ESN0_DB, MAIN_BATCH, device=dev).block_errors,
        torch.zeros(1, device=dev), MAIN_BATCH, dev, card)
    out["profile_sim_p1"] = dict(
        {k: p1[k] for k in ("ms_per_call", "device_busy_ms", "device_idle_share",
                            "kernels_per_call")},
        launches=launched("ldpc_layered"), seconds=watch.lap())
    return out


def benchmark_cut(traffic: dict) -> dict:
    """A cell's short cut, from its traffic alone: 2 trials of one fetch
    window of one call (at most 40 host fetches where the cell fetches after
    every call), 1 warm-up call, a profiled window of at most 4 fetches of 1
    call.  The cell's sample sizes stay."""
    return dict(calls_per_fetch=1, fetches_per_trial=min(traffic["fetches_per_trial"], 40),
                warmup_calls=1, trials=2, profile_fetches=min(traffic["profile_fetches"], 4),
                profile_calls_per_fetch=1)


def benchmark_launches(spec: dict, cut: dict, sms: int) -> dict:
    """The decode launches a run of cell ``spec`` at ``cut`` makes, by
    (kernel, codewords per block, layout) as ``LAUNCHES_BY_P`` counts them:
    all of the shape ``launch_shape`` gives the timed step, one per step and
    rv stage of the warm-up, the trials and the profiled window, and one for
    the sample."""
    from benchmark_torch import cells
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    traffic = {**spec["traffic"], **cut}
    cfg = cells.chain_config(spec["configuration"])
    shape = decoder_cuda.launch_shape(cfg.params, traffic["batch_per_step"] * cfg.params.C,
                                      cfg.schedule, cfg.codewords_per_block, sms, cfg.algorithm,
                                      cfg.message_dtype)
    steps = traffic["steps_per_call"] * (
        traffic["warmup_calls"]
        + traffic["trials"] * traffic["fetches_per_trial"] * traffic["calls_per_fetch"]
        + traffic["profile_fetches"] * traffic["profile_calls_per_fetch"])
    key = (decoder_cuda.KERNEL_NAMES[cfg.schedule], shape["codewords_per_block"],
           shape["layout"])
    return {key: steps * len(cfg.rv_sequence) + 1}


def phase_benchmark(dev):
    """Each cell of ``BENCHMARK.json`` once through ``benchmark_torch.run``
    at its ``benchmark_cut``, the launch counts set to 0 before it and read
    after: the cell's decode kernel and no other launched, every launch of
    the shape that ``launch_shape`` gives the timed step (codewords per
    block and layout; layout 2 or 3 is the flooding cluster kernel, which
    the profiled window must then name as its only decode kernel, and
    otherwise not name), one per step of the warm-up, the trials and the
    profiled window and one for the sample's path at its
    ``sample_path_tbs``; every metric measured, the
    decode kernel's share of its bound in (0, 1], the cell's checks (the
    timed path's sample equal to the plain decoder at tolerance 0, block
    errors and mean iterations against their references) all true.  Then
    the cell's control (its ``control.chain`` in ``BENCHMARK.json``) at the
    same cut but for the C++ oracle's comparison, its sample held to the
    sound run's plain decode, which must come out incorrect.  Each with its
    seconds."""
    from benchmark_torch import cells, trace
    from benchmark_torch import run as benchmark
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name in cells.names():
        t0 = time.perf_counter()
        spec = cells.cell(name)
        cut = benchmark_cut(spec["traffic"])
        want = benchmark_launches(spec, cut, sms)
        ((_, _, layout),) = want
        traffic = {**spec["traffic"], **cut}
        path_tbs = traffic.get("sample_path_tbs", traffic["sample_tbs"])
        torch.cuda.synchronize()
        decoder_cuda.reset_launches()
        lines = []
        rec = benchmark.run_cell(name, seed=0, device=dev, cut=cut, out=lines.append)
        torch.cuda.synchronize()
        by_shape = dict(decoder_cuda.LAUNCHES_BY_P)
        checks = json.loads(next(ln for ln in lines if ln.startswith("checks: "))[8:])
        breakdown = json.loads(next(ln for ln in lines if ln.startswith("breakdown: "))[11:])
        decode_names = sorted(k for k in breakdown["kernels_per_step_by_name"]
                              if trace.DECODE_KERNEL.search(k))
        out[name] = dict(record=rec, checks=checks,
                         launches_by_shape={str(k): n for k, n in by_shape.items()},
                         decode_kernels_in_window=decode_names,
                         sample_path_tbs=checks["sample"]["path_tbs"],
                         seconds=time.perf_counter() - t0)
        missing = [k for k in cells.metric_units() if rec[k] is None]
        share = rec["decode_kernel_share_of_bound"]
        # every launch counted by (kernel, P, layout): only the cell's kernel,
        # at the timed step's shape; the window names the same __global__;
        # the sample's path decoded as many TBs as the cell says
        if (not rec["correct"] or missing or not 0 < share <= 1 or by_shape != want
                or checks["sample"]["path_tbs"] != path_tbs or not decode_names
                or any(("ldpc_flooding_cluster_kernel" in k) != (layout >= 2)
                       for k in decode_names)):
            raise AssertionError(f"benchmark cell {name} (launches wanted {want}): {out[name]}")
        t0 = time.perf_counter()
        lines = []
        # the control without the C++ oracle's comparison: it holds the plain
        # decoder to the oracle on LLRs that the control does not touch, as
        # the run above did; its sample compares with the plain decode that
        # the run above made (``checks.plain_tb_decode``)
        control = benchmark.run_cell(name, seed=0, device=dev, cut={**cut, "oracle_tbs": 0},
                                     out=lines.append, chain=spec["control"]["chain"])
        out[name]["control"] = dict(
            chain=spec["control"]["chain"], correct=control["correct"],
            checks=json.loads(next(ln for ln in lines if ln.startswith("checks: "))[8:]),
            seconds=time.perf_counter() - t0)
        if control["correct"]:
            raise AssertionError(f"benchmark cell {name}: its control came out correct: "
                                 f"{out[name]['control']}")
    return out


EXPERIMENTS_BATCH = 512
EXPERIMENTS_BF16_BATCH = 256
EXPERIMENTS_GATE_BLOCKS = 2048
# the baseline and three of the 15 candidates, V5's (0.65, 2) among them
EXPERIMENTS_SCHEDULES = ((0.55, 1), (0.65, 2), (0.75, 3))


def phase_experiments(dev):
    """The four experiment tools' row functions on the card at a cut, each
    with the launch counts set to 0 before it and read after: each launches
    the kernels it should and no other, one row of each equals its plain
    version (tolerance 0), every ``exp_kernel_tiles`` alternative equals the
    rules' launch, the alpha scan's 0.8125 row and the schedule screen's
    baseline agree on the same LLRs, and the baseline's -0.75 dB gate lies
    inside the two-sample bound of ``golden/bench_path_bler.json``."""
    from ldpc_3gpp_tpu_torch.bench import _flagship_config
    from ldpc_3gpp_tpu_torch.ops import decoder_cuda
    from ldpc_3gpp_tpu_torch.tools import exp_alpha, exp_alpha_schedule, exp_bf16
    from ldpc_3gpp_tpu_torch.tools import exp_kernel_tiles

    def counted(run, *kernels):
        torch.cuda.synchronize()
        decoder_cuda.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = dict(decoder_cuda.LAUNCHES)
        if any((got[k] > 0) != (k in kernels) for k in got):
            raise AssertionError(f"expected launches of {kernels} only, got {got}")
        return out, got

    def plain_equal(params, llr, row, **kw):
        return require_equal(row["result"], decoder_cuda.decode_plain(params, llr, **kw),
                             row["name"])

    def summary(rows, *keys):
        return [{k: r[k] for k in ("name", *keys) if k in r} for r in rows]

    out, watch = {}, Stopwatch()
    cfg = _flagship_config(exp_alpha.ITERATIONS)
    params = cfg.params
    cw, llr = exp_alpha.cw_llrs(params, EXPERIMENTS_BATCH, exp_alpha.ESN0_DB,
                                exp_alpha.NOISE_SEED, dev)
    rows, launches = counted(lambda: exp_alpha.alpha_rows(params, llr, cw), "ldpc_layered")
    base = next(r for r in rows if r["alpha"] == 0.8125)
    diff = plain_equal(params, llr, base, alpha=0.8125, **exp_alpha.DECODE_KW)
    out["exp_alpha"] = dict(
        codewords=EXPERIMENTS_BATCH, launches=launches, plain_row=base["name"],
        max_abs_diff=diff, rows=summary(rows, "mean_iterations", "block_errors",
                                        "us_per_codeword"), seconds=watch.lap())

    screened, launches = counted(lambda: exp_alpha_schedule.screen(
        params, llr, cw, EXPERIMENTS_SCHEDULES), "ldpc_layered")
    v5 = next(r for r in screened if r["alpha_schedule"] == (0.65, 2))
    diff = plain_equal(params, llr, v5, alpha_schedule=(0.65, 2), **exp_alpha.DECODE_KW)
    if (screened[0]["mean_iterations"], screened[0]["block_errors"]) != (
            base["mean_iterations"], base["block_errors"]):
        raise AssertionError(f"schedule baseline {screened[0]} against alpha 0.8125 {base}")
    esn0_db, errors, blocks, seed = exp_alpha_schedule.GATE_POINTS[0]
    gate, gate_launches = counted(lambda: exp_alpha_schedule.gate_row(
        cfg, screened[0], EXPERIMENTS_GATE_BLOCKS, dev, points=((esn0_db, errors, blocks, seed),),
    ), "ldpc_layered")
    point = gate["points"][0]
    out["exp_alpha_schedule"] = dict(
        codewords=EXPERIMENTS_BATCH, launches=launches, plain_row=v5["name"], max_abs_diff=diff,
        rows=summary(screened, "mean_iterations", "block_errors", "us_per_codeword"),
        baseline_gate=dict(point, launches=gate_launches, bound=two_sample_gate(
            "exp_alpha_schedule baseline", esn0_db, point["blocks"], point["block_errors"],
            blocks, errors)),
        seconds=watch.lap())

    cw_bf, llr_bf = exp_alpha.cw_llrs(params, EXPERIMENTS_BF16_BATCH, exp_alpha.ESN0_DB,
                                    exp_alpha.NOISE_SEED, dev)
    rows, launches = counted(lambda: exp_bf16.bf16_rows(params, llr_bf, cw_bf),
                             "ldpc_layered", "ldpc_flooding")
    row = next(r for r in rows if r["name"] == "flooding bfloat16 threads=512")
    diff = plain_equal(params, llr_bf, row, iterations=exp_alpha.ITERATIONS, algorithm="min-sum",
                       schedule="flooding", message_dtype="bfloat16")
    misfits = [r["name"] for r in rows if not r["fits"]]
    if len(misfits) != 4 or any(" P=1" in name for name in misfits):
        raise AssertionError(f"exp_bf16: shapes that do not fit Z=384: {misfits}")
    out["exp_bf16"] = dict(
        codewords=EXPERIMENTS_BF16_BATCH, launches=launches, plain_row=row["name"],
        max_abs_diff=diff, misfits=misfits,
        rows=summary(rows, "launch", "block_errors", "parity_failures", "us_per_codeword"),
        seconds=watch.lap())

    def tiles():
        rows = []
        for case, n, kw, ps, threads in exp_kernel_tiles.CASES:
            p, x = exp_kernel_tiles.case_inputs(case, n, dev)
            rows.append((p, x, kw, exp_kernel_tiles.case_rows(case, p, x, kw, ps, threads)))
        return rows

    cases, launches = counted(tiles, "ldpc_layered", "ldpc_flooding")
    p, x, kw, rows = cases[1]
    row = next(r for r in rows if r["name"] == "config #1 layered P=4")
    diff = plain_equal(p, x, row, schedule="layered", **kw)
    rows = [r for _, _, _, case_rows in cases for r in case_rows]
    fitting = [r for r in rows if r["fits"]]
    if not all(r["equal_to_the_rule"] for r in fitting) or sum(
            r["rule_choice"] for r in fitting) != 2 * len(cases):
        raise AssertionError(f"exp_kernel_tiles: {summary(rows, 'equal_to_the_rule')}")
    out["exp_kernel_tiles"] = dict(
        launches=launches, plain_row=row["name"], max_abs_diff=diff,
        rows=summary(rows, "launch", "rule_choice", "equal_to_the_rule", "ms", "mean_sweeps"),
        seconds=watch.lap())
    return out


VARIANTS = [
    ("V1", LAYERED_SOURCE, TPU_KERNEL),
    ("V1-flagship", LAYERED_SOURCE, TPU_KERNEL),
    ("V1'", LAYERED_SOURCE, TPU_KERNEL + " (:213-214, 243-261, 358-359)"),
    ("V4-layered", LAYERED_SOURCE, TPU_KERNEL + " (:494-500, 549-573)"),
    ("V5", LAYERED_SOURCE, TPU_KERNEL + " (:428-440)"),
    ("V2", LAYERED_SOURCE, TPU_KERNEL + " (:228-239)"),
    ("V6-layered", LAYERED_SOURCE, TPU_KERNEL + " (:492, 633-635)"),
    ("V3-SP", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V3-NMS", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V3-NMS-config1", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V3-OMS", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V3-SP-cluster", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V3-NMS-cluster", FLOODING_SOURCE, TPU_KERNEL + " (:317-333, 442-458, 477-484, 501-511)"),
    ("V4-flooding", FLOODING_SOURCE, TPU_KERNEL + " (:494-500, 549-573)"),
    ("V6-flooding", FLOODING_SOURCE, TPU_KERNEL + " (:480-484, 633-635)"),
    ("V7-layered", LAYERED_SOURCE, TPU_PACKING),
    ("V7-flooding", FLOODING_SOURCE, TPU_PACKING),
]


def ptxas_entries(log):
    """{kernel entry: registers, stack and spill bytes} from ``ptxas -v``."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    return out


def check_registers():
    """``ptxas -v`` of the kernels held to a register budget, each without
    stack or spills: the one-codeword and packed layered kernels' min-sum
    family instantiations (float and bfloat16 messages; the one-codeword
    kernel's for each rule) at most 80 registers (two 384-thread blocks per
    SM); the warp kernel's four (each rule and message type) at most 128 (one
    block of WARP_FORM_MAX_THREADS per SM); the one-codeword layered
    sum-product kernel (V2) at most 72 (four 224-thread blocks per SM at P3's
    shape); the packed flooding kernel's six
    instantiations (three rules and message types, messages on chip or in a
    scratch), the flooding cluster kernel's three and the one-codeword
    flooding kernel's three at most 64 (1,024 threads per SM).  Returns their
    records by group."""
    from ldpc_3gpp_tpu_torch import kernels_build

    layered = ptxas_entries(kernels_build.build_log("ldpc_layered"))
    flooding = ptxas_entries(kernels_build.build_log("ldpc_flooding"))
    groups = {  # name: (entries, most registers, count)
        "layered_min_sum_family": ({k: v for k, v in layered.items()
                                    if k.startswith("_Z27ldpc_layered_min_sum_kernel")
                                    or ("ldpc_layered_packed_kernel" in k and "ILb0E" in k)},
                                   80, 6),
        "warp_form": ({k: v for k, v in layered.items()
                       if k.startswith("_Z24ldpc_layered_warp_kernel")}, 128, 4),
        "V2": ({k: v for k, v in layered.items()
                if k.startswith("_Z22ldpc_layered_sp_kernel")}, 72, 1),
        "packed_flooding": ({k: v for k, v in flooding.items()
                             if "ldpc_flooding_packed_kernel" in k}, 64, 6),
        "cluster_flooding": ({k: v for k, v in flooding.items()
                              if "ldpc_flooding_cluster_kernel" in k}, 64, 3),
        "one_block_flooding": ({k: v for k, v in flooding.items()
                                if k.startswith("_Z20ldpc_flooding_kernel")}, 64, 3),
    }
    for name, (entries, most, count) in groups.items():
        bad = {k: v for k, v in entries.items()
               if v.get("registers", 999) > most or v.get("stack", 1)
               or v.get("spill_stores", 1) or v.get("spill_loads", 1)}
        if len(entries) != count or bad:
            raise AssertionError(f"{name}: over {most} registers, stack, spills or "
                                 f"missing: {entries}")
    return {name: entries for name, (entries, _, _) in groups.items()}


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

    watch = Stopwatch()
    libs = kernels_build.build()
    ptxas = [ln for n in libs for ln in kernels_build.build_log(n).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": watch.lap(), "kernels": sorted(libs),
          "ptxas": ptxas, "registers": check_registers()})

    tally = Tally()
    edges, config1, ties = phase_kernel_vs_plain(dev, tally)
    emit({"phase": "kernel_vs_plain", "seconds": watch.lap(), "cases": tally.total,
          "max_abs_diff": tally.max_abs_diff, "tolerance": 0,
          "cases_by_variant": dict(tally.cases), "flooding_layout_edges": edges,
          "config1_launch": config1, "tie_cases_llrs_at_smallest_level_by_Z": ties})

    compared, mixes, plain_cases = phase_packed_vs_plain(dev, tally)
    rounds = warp_form_rounds(dev, tally)
    packed_flooding = phase_packed_flooding(dev, tally)
    emit({"phase": "packed_vs_plain", "seconds": watch.lap(),
          "cases": tally.cases["V7-layered"] + tally.cases["V7-flooding"],
          "max_abs_diff": max(tally.worst["V7-layered"], tally.worst["V7-flooding"]),
          "tolerance": 0, "codewords": 53, "plain_version_cases": plain_cases + len(rounds),
          "warp_form_rounds": rounds,
          "codewords_per_block_by_Z": compared,
          "sweeps_high_noise_kinds": mixes,
          "packed_flooding_shapes": packed_flooding})

    emit({"phase": "phi", "seconds": watch.lap(), **phase_phi(dev)})

    launches = {}  # variant -> launches on the path that runs it
    generator = make_generator(0, dev)
    cfg = flagship_config()
    blocks, errors, iters, n = counted_steps(
        cfg, generator, MAIN_ESN0_DB, MAIN_BATCH, MAIN_STEPS, dev)
    emit({"phase": "main_path", "seconds": watch.lap(),
          "config": "BG1 A=8424 G=25272 Z=384 QPSK "
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
    emit({"phase": "main_path_2", "seconds": watch.lap(),
          "config": "BG2 A=3842 G=11526 C=2 Z=208 QPSK "
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

    emit({"phase": "chain_gpu_vs_cpu", "cases": phase_chain_gpu_vs_cpu(dev),
          "seconds": watch.lap()})

    points, p4_launches = phase_bler_gate(generator, dev)
    emit({"phase": "bler_gate", "seconds": watch.lap(), "points": points})
    launches["V6-layered"] = p4_launches["ldpc_layered"]

    p3, p3_launches = phase_path_3(generator, dev)
    emit({"phase": "path_3", "seconds": watch.lap(),
          "config": "BG2 A=2048 G=6144 Z=208 QPSK "
          "sum-product 8 it early termination", "esn0_db": P3_ESN0_DB,
          "schedules": p3})
    launches["V2"] = p3_launches["layered"]

    steps = phase_variant_steps(generator, dev)
    emit({"phase": "variant_steps", "seconds": watch.lap(), "variants": steps})
    launches.update({v: rec["launches"] for v, rec in steps.items()})

    lifting = phase_lifting_sweep(dev)
    emit({"phase": "lifting_sweep", **lifting, "seconds": watch.lap()})
    launches["V3-NMS-cluster"] = lifting["cluster_launches"]

    p5 = phase_path_5(dev)
    emit({"phase": "path_5", "seconds": watch.lap(), **p5})
    launches["V7-flooding"] = p5["bler_vs_snr_explicit_P"]["packed_launches"]
    launches["V3-SP-cluster"] = p5["snr_vs_a"]["cluster_launches"]

    qam, qam_launches = phase_qam64_gate(dev)
    emit({"phase": "qam64_gate", "seconds": watch.lap(), "points": qam,
          "launches": qam_launches})

    emit({"phase": "mxu_encoder", "card": card, **phase_mxu_encoder(dev),
          "seconds": watch.lap()})
    emit({"phase": "reference_decoder", "card": card,
          **phase_reference_decoder(dev), "seconds": watch.lap()})
    with tempfile.TemporaryDirectory() as tmp:
        entry = phase_entry_points(dev, tmp)
    emit({"phase": "entry_points", **entry, "seconds": watch.lap()})

    emit({"phase": "distributed", "card": card, **phase_distributed(dev),
          "seconds": watch.lap()})
    with tempfile.TemporaryDirectory() as tmp:
        campaign = phase_campaign(tmp)
    emit({"phase": "campaign", "card": card, **campaign, "seconds": watch.lap()})
    with tempfile.TemporaryDirectory() as tmp:
        goldens = phase_goldens(dev, tmp)
    emit({"phase": "goldens", "card": card, **goldens, "seconds": watch.lap()})

    emit({"phase": "bench", "card": card, **phase_bench(dev, card), "seconds": watch.lap()})
    emit({"phase": "experiments", "card": card, **phase_experiments(dev),
          "seconds": watch.lap()})
    bench = phase_benchmark(dev)
    emit({"phase": "benchmark", "card": card, **bench, "seconds": watch.lap()})
    launches["V3-NMS-config1"] = sum(
        bench["config1_bg2_a100_b524288"]["launches_by_shape"].values())
    launches["V1-flagship"] = sum(bench["flagship_headline"]["launches_by_shape"].values())

    times = phase_times(generator, dev, card)
    emit({"phase": "times", "seconds": watch.lap()})
    per_sm = {v: times[v]["blocks_per_sm"]
              for v in ("V1", "V1-flagship", "V1'", "V4-layered", "V5", "V6-layered")}
    if set(per_sm.values()) != {2}:
        raise AssertionError(f"layered min-sum kernels not at 2 blocks per SM: {per_sm}")
    if times["V2"]["blocks_per_sm"] != 4:
        raise AssertionError(f"V2 not at 4 blocks per SM at P3's shape: {times['V2']}")

    k2, rates = phase_op_rates(dev, times)
    emit({"phase": "op_rates", "seconds": watch.lap(), "card": card, "K2": k2,
          "rates_by_block_shape": rates,
          "measured_rate_ms": {v: {k: m[k] for k in (
              "measured_rate_ms", "measured_rate_sum_ms", "arithmetic_ms",
              "shared_memory_ms", "scratch_ms", "ms", "bound_ms")}
              for v, m in times.items()}})

    kernels = []
    for variant, source, replaces in VARIANTS:
        m = times[variant]
        if launches[variant] < 1:
            raise AssertionError(f"{variant} was launched on no path")
        diff = max(tally.worst.get(variant, 0), m["max_abs_diff"])
        kernels.append({
            "name": f"{os.path.splitext(os.path.basename(source))[0]}/"
                    f"{'V7' if variant.startswith('V7') else variant}",
            "route": "cuda", "source": source, "replaces": replaces,
            "variant": variant, "cases": tally.cases.get(variant, 0) + 1,
            "launches": launches[variant], "max_abs_err": diff,
            "max_abs_diff": diff, "tolerance": 0,
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "measured_rate_ms": m["measured_rate_ms"],
            "bytes_ms": m["bytes_ms"], "operations_ms": m["operations_ms"],
            "scratch_traffic_ms": m["scratch_traffic_ms"],
            "mean_sweeps": m["mean_sweeps"], "codewords": m["codewords"],
            "codewords_per_block": m["codewords_per_block"],
            "card": card,
        })
    if k2["launches"] < 1:
        raise AssertionError("op_rates was launched on no path")
    kernels.append({
        "name": "op_rates/K2", "route": "cuda", "source": OP_RATES_SOURCE,
        "replaces": TPU_OP_RATES, "variant": "K2",
        "max_abs_err": k2["max_abs_diff"], "tolerance": 0, "library_ms": None, "card": card, **k2})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
