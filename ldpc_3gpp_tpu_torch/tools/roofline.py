"""Roofline of the BP decode kernels on an NVIDIA GPU.

The counterpart of the JAX package's ``tools/roofline.py``.  For each row it
decodes a batch of noisy codewords with the CUDA kernel of the row's schedule
and reports the time per codeword, the update sweeps the data needed, the
operations per codeword, the least time the card could take for the same
work (``kernel_bound``: bytes over the memory rate or operations over the
float32 rate, whichever is larger, and which of the two bounds it), the
time the same work takes at the rates the op-rate microbenchmark (kernel
K2, ``tools/op_rates.py``) measured in the kernel's own block shape
(``measured_rate``), and the kernel's share of its bound (bound over time).

Op model (per edge and lane of one update sweep, min-sum family): parity
xor, subtract, magnitude and, sign xor, min/max/min tournament, compare,
select, own-sign and/xor, add: ``OPS_PER_EDGE_LANE`` = 12.  The JAX tool also
counts two scalings per row and lane (12 d + 2 per row) and, for flooding,
2 nc per sweep; the port's kernels scale once per row and share it over the
row's lanes, so those are not in the count (``update_ops_per_sweep``).
Sum-product: ``OPS_PER_EDGE_LANE_SUM_PRODUCT`` (two ``phi`` of 65 and 13
more).  A syndrome pass is one operation per edge and lane.

The TPU tool states its ceiling as an assumption about the v5e vector unit
(6.4 T vector ops/s, from its lane count and clock).  That ceiling has no
counterpart here: the peaks are the H100's published ones (``PEAK_*``, at
the full 700 W; the card's power limit is printed beside every row), and
the rates the card really sustains in each block shape are measured by K2.

    python3 -m ldpc_3gpp_tpu_torch.tools.roofline [--device cuda|cpu]
        [--batch 512] [--reps 20]

prints one JSON line per row (the JAX tool's three rows, at its batch of
512 transport blocks) and the peaks.  With ``--device cpu`` it times the
plain versions with the host clock and measures no rate: a check of the
arithmetic, not a roofline.  Also the home of ``kernel_bound``,
``measured_rate`` and ``measure_variant``, which ``chip_smoke.py`` uses for
its ``kernels`` line.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from ..utils.profiling import time_ms

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

# The JAX tool's rows (tools/roofline.py:139-147): name, code, iterations,
# Es/N0, schedule; normalized min-sum, early termination, at its batch of 512
ROWS = (
    ("BG1 Z=384 layered NMS 12it (bench)", dict(BG=1, A=8424, G=25272, Q_m=2), 12, 1.0,
     "layered"),
    ("BG1 Z=384 flooding NMS 12it", dict(BG=1, A=8424, G=25272, Q_m=2), 12, 1.0,
     "flooding"),
    ("BG2 Z=208 layered NMS 8it", dict(BG=2, A=3842, G=11526, Q_m=2), 8, 0.75, "layered"),
)
BATCH = 512


def update_ops_per_sweep(params, algorithm="min-sum") -> int:
    """Operations of one update sweep of one codeword: per edge and lane,
    ``OPS_PER_EDGE_LANE`` (min-sum family) or
    ``OPS_PER_EDGE_LANE_SUM_PRODUCT``."""
    per_update = (OPS_PER_EDGE_LANE_SUM_PRODUCT if algorithm == "sum-product"
                  else OPS_PER_EDGE_LANE)
    return len(params.edges[0]) * params.Z_c * per_update


def kernel_bound(params, res, budget, n_in_cols, out_cols, *, schedule="layered",
                 algorithm="min-sum", early_termination=True, scratch_bytes=0,
                 shape=None):
    """Least time (ms) the card could take for this run's decodes.

    Bytes: each input LLR read once, each output bit and flag written once.
    Operations: ``update_ops_per_sweep`` for every update sweep this run's
    data needed, and one per edge and lane for every syndrome pass.  Layered
    with early termination: a codeword that passed at sweep ``it`` ran
    ``it + 1`` update sweeps, one that never passed the budget and one
    syndrome pass.  Flooding with early termination: ``it`` update sweeps
    and ``it + 1`` syndrome passes (the budget and budget + 1 if it never
    passed).  A run to budget: the budget and one syndrome pass.

    Beside the bound, the work of the kernel's own design for
    ``measured_rate``; ``shape`` is ``decoder_cuda.launch_shape``'s record.
    Layered: a codeword's ``scratch_bytes`` (its share of
    ``decoder_cuda.scratch_shape``: the min-sum family's compressed words,
    nr*Z*12 B, or 8 with bfloat16 messages; else E*Z messages) written once
    per update sweep and read once per update sweep after the first.
    Flooding: a message phase per update sweep plus the one whose vote stops
    the codeword (its messages are discarded), a parity-only pass where the
    budget is reached; messages written by the message phase and read by the
    column phase and by the next message phase, in shared memory (the
    block's or the cluster's), or in the packed kernel's scratch (layout
    0)."""
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
    nbytes = n * (n_in_cols * Z * 4 + out_cols * Z + 8)
    ops = (update_ops_per_sweep(params, algorithm) * total_updates
           + E * Z * OPS_PER_EDGE_LANE_SYNDROME * total_syndromes)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    reads = updates - (updates > 0).to(torch.int64)  # sweep 0 reads no message
    if schedule == "flooding" and shape is not None:
        # message phases: the updates, and the discarded one of a codeword
        # whose vote passed before the budget
        stopped = passed & (used < budget) if early_termination else torch.zeros_like(passed)
        phases = int((updates + stopped.to(torch.int64)).sum())
        parity_only = int((~stopped).sum())
        # per edge and lane, all in shared memory (a cluster's included) but
        # for the packed kernel's scratch form: a rotated total read per
        # phase, the message read (after sweep 0) and write of a message
        # phase, and the column phase's message read
        messages = E * Z * (phases + int(reads.sum()) + total_updates)
        in_scratch = shape["layout"] == 0
        shared = E * Z * (phases + parity_only) + (0 if in_scratch else messages)
        work = dict(update_edge_lanes=E * Z * phases,
                    syndrome_edge_lanes=E * Z * parity_only,
                    shared_accesses=shared, scratch_bytes=4 * messages if in_scratch else 0)
    else:
        work = dict(update_edge_lanes=E * Z * total_updates,
                    syndrome_edge_lanes=E * Z * total_syndromes,
                    # an update reads and writes a total, a syndrome pass reads
                    shared_accesses=E * Z * (2 * total_updates + total_syndromes),
                    scratch_bytes=scratch_bytes * int((updates + reads).sum()))
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops,
        bytes=nbytes, operations=ops,
        mean_sweeps=total_updates / n,
        # the device-memory traffic of this design, for PERF.md; not part of
        # the bound
        scratch_traffic_ms=work["scratch_bytes"] / PEAK_BYTES_PER_S * 1e3,
        **work,
    )


# The operations of one edge and lane in an update sweep by the class of the
# op-rate microbenchmark they fall in (they add up to OPS_PER_EDGE_LANE and
# OPS_PER_EDGE_LANE_SUM_PRODUCT; phi's arithmetic counts as multiply/add).
OP_MIX = {
    "min-sum": {"bitops": 5, "addmul": 2, "minmax": 3, "select": 2},
    "sum-product": {"addmul": 134, "bitops": 5, "select": 4},
}


def measured_rate(work, rates, algorithm):
    """Time (ms) the same work takes at the rates the op-rate microbenchmark
    measured in this kernel's block shape: the arithmetic by class (classes
    share the instruction slots, so their times add), the shared-memory
    accesses of the design (``kernel_bound``; a rotation is one rotated read
    and one write, two accesses), and the scratch traffic at the scratch
    stream's rate.  The three overlap at best, so ``measured_rate_ms`` is the
    largest; their sum is given too."""
    mix = OP_MIX["sum-product" if algorithm == "sum-product" else "min-sum"]
    alu = sum(work["update_edge_lanes"] * count / rates[c]["operations_per_s"]
              for c, count in mix.items())
    alu += work["syndrome_edge_lanes"] / rates["bitops"]["operations_per_s"]
    shared = 0.5 * work["shared_accesses"] / rates["rotate"]["operations_per_s"]
    scratch = work["scratch_bytes"] / rates["scratch"]["bytes_per_s"]
    parts = dict(arithmetic_ms=alu * 1e3, shared_memory_ms=shared * 1e3,
                 scratch_ms=scratch * 1e3)
    return dict(measured_rate_ms=max(parts.values()),
                measured_rate_sum_ms=sum(parts.values()), **parts)


def rate_shape(m) -> tuple:
    """The op-rate microbenchmark's block shape (threads, lanes, edges,
    blocks per SM) for a ``measure_variant`` record: a packed block's lanes
    form one run of P*Z, as one codeword's Z do; a one-codeword flooding
    block wider than K2's MAX_THREADS is taken as blocks of MAX_THREADS with
    as many threads per SM."""
    from . import op_rates

    threads, per_sm = m["threads"], m["blocks_per_sm"]
    if threads > op_rates.MAX_THREADS:
        threads, per_sm = (op_rates.MAX_THREADS,
                           max(1, threads * per_sm // op_rates.MAX_THREADS))
    return (threads, m["Z"] * m["codewords_per_block"], m["E"], per_sm)


def scratch_per_codeword(params, n, P, kw) -> float:
    """Bytes of message scratch per codeword that ``decode`` gives a launch
    of ``n`` codewords, ``P`` per block, with the arguments ``kw``."""
    from ..ops import decoder_cuda

    spec = decoder_cuda.scratch_shape(
        params, n, kw.get("schedule", "layered"), kw.get("algorithm", "min-sum"),
        kw.get("message_dtype", "float32"), P)
    if spec is None:
        return 0
    shape, dtype = spec
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size() / (shape[0] * P)


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


def noisy_d_tilde(params, modulation, esn0_db, n, seed, dev):
    """(n, C, N) circular-buffer LLRs of numpy-seeded blocks through the
    port's own encode / demodulate chain at ``esn0_db``; also the bits."""
    from ..models.decoder import split_rate_matched_symbols
    from ..models.encoder import encode_to_symbols
    from ..ops.channel import esn0_to_variance

    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 2, (n, params.A)).astype(np.int8)).to(dev)
    noise_var = esn0_to_variance(esn0_db, device=dev)
    tx = encode_to_symbols(params, a, modulation)
    std = math.sqrt(float(noise_var) / 2.0)
    noise = (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape)) * std
    rx = tx + torch.from_numpy(noise.astype(np.complex64)).to(dev)
    return split_rate_matched_symbols(params, rx, modulation, noise_var), a


def measure_variant(params, llr, reps, plain=True, **kw):
    """One kernel variant at its path's shape: time by CUDA events, the
    plain version's time (one run) and equality with it (with ``plain``),
    the bound and the launch shape.  For a CPU tensor ``decode`` runs the
    plain version, timed by the host clock, the launch shape is the one an
    H100 (132 SMs) would get and ``blocks_per_sm`` is None."""
    from ..ops import decoder_cuda

    dev = llr.device
    on_card = dev.type == "cuda"
    res = decoder_cuda.decode(params, llr, **kw)
    ms = time_ms(lambda: decoder_cuda.decode(params, llr, **kw), reps=reps, device=dev)
    holder = {}

    def run_plain():
        holder["res"] = decoder_cuda.decode_plain(params, llr, **kw)

    plain_ms = diff = None
    if plain:
        plain_ms = time_ms(run_plain, reps=1, warmup=0, device=dev)
        diff = require_equal(res, holder["res"], kw)
    n = res.iterations.numel()
    schedule = kw.get("schedule", "layered")
    launch = decoder_cuda.launch_shape(
        params, n, schedule, kw.get("codewords_per_block", 0),
        torch.cuda.get_device_properties(dev).multi_processor_count if on_card else 132)
    nc = params.num_cols
    bound = kernel_bound(
        params, res, kw["iterations"],
        nc - 2 if kw.get("channel_format") == "d" else nc,
        params.num_sys_cols if kw.get("output_format") == "sys" else nc,
        schedule=kw.get("schedule", "layered"),
        algorithm=kw.get("algorithm", "min-sum"),
        early_termination=kw.get("early_termination", True),
        scratch_bytes=scratch_per_codeword(params, n, launch["codewords_per_block"], kw),
        shape=launch,
    )
    shape = dict(
        Z=params.Z_c, E=len(params.edges[0]), **launch,
        blocks_per_sm=decoder_cuda.blocks_per_sm(
            params, schedule, kw.get("algorithm", "min-sum"),
            kw.get("message_dtype", "float32"), launch["codewords_per_block"], n)
        if on_card else None)
    return dict(ms=ms, us_per_codeword=ms * 1e3 / n, plain_ms=plain_ms,
                max_abs_diff=diff, codewords=n, algorithm=kw.get("algorithm", "min-sum"),
                **shape, **bound)


def measure_row(name, fields, iterations, esn0_db, schedule, batch, dev, reps, rates_cache,
                card) -> dict:
    """One roofline row: the kernel at ``batch`` transport blocks of the
    row's code on LLRs through the port's chain (numpy seed 0), its bound,
    its measured-rate time (on the card) and its share of the bound."""
    from ..ops import decoder_cuda
    from ..spec.params import LDPCParams
    from . import op_rates

    params = LDPCParams(**fields)
    d, _ = noisy_d_tilde(params, "QPSK", esn0_db, batch, 0, dev)
    kw = dict(iterations=iterations, algorithm="min-sum", schedule=schedule,
              channel_format="d", output_format="sys")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches0 = dict(decoder_cuda.LAUNCHES)
    m = measure_variant(params, d, reps, plain=False, **kw)
    launches = {k: v - launches0[k] for k, v in decoder_cuda.LAUNCHES.items()}
    rates = None
    if dev.type == "cuda":
        key = rate_shape(m)
        if key not in rates_cache:
            rates_cache[key] = op_rates.rates(*key, dev)
        rates = rates_cache[key]
        m.update(measured_rate(m, rates, "min-sum"))
    n = m["codewords"]
    on_card = dev.type == "cuda"
    return {
        "name": name, "BG": params.BG, "Z": params.Z_c, "schedule": schedule,
        "iterations": iterations, "esn0_db": esn0_db, "transport_blocks": batch,
        "codewords": n, "us_per_codeword": m["us_per_codeword"], "ms": m["ms"],
        "mean_sweeps": m["mean_sweeps"],
        "operations_per_codeword": m["operations"] / n,
        "update_operations_per_sweep_per_codeword": update_ops_per_sweep(params),
        "achieved_operations_per_s": m["operations"] / (m["ms"] / 1e3) if on_card else None,
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "bytes_ms": m["bytes_ms"], "operations_ms": m["operations_ms"],
        "measured_rate_ms": m.get("measured_rate_ms"),
        "share_of_bound": m["bound_ms"] / m["ms"] if on_card else None,
        "share_of_measured_rate": (None if rates is None else m["measured_rate_ms"] / m["ms"]),
        "codewords_per_block": m["codewords_per_block"], "threads": m["threads"],
        "layout": m["layout"], "blocks_per_sm": m["blocks_per_sm"],
        "launches": launches,
        "rate_shape": None if rates is None else list(rate_shape(m)),
        "device": card,
        "timed_by": "CUDA events" if on_card else
                    "host clock (plain versions on the CPU: not a device time)",
    }


def main(argv=None) -> list:
    from ..utils.artifacts import card_label
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m ldpc_3gpp_tpu_torch.tools.roofline", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=BATCH, help="transport blocks per row")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per row")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    print(json.dumps({"peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                                "float32_operations_per_s": PEAK_OPS_PER_S,
                                "at": "NVIDIA H100 SXM data sheet, 700 W"},
                      "device": card}), flush=True)
    rows, cache = [], {}
    for name, fields, iterations, esn0_db, schedule in ROWS:
        row = measure_row(name, fields, iterations, esn0_db, schedule, args.batch, dev,
                          args.reps, cache, card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
