"""Campaign Monte-Carlo (BASELINE config #5): >= 1e9 code blocks across a
full BG1+BG2 x modulation matrix, counters summed over every rank.

The counterpart of the repository's ``tools/pod_campaign.py``.  Each matrix
entry calibrates its Es/N0 operating point (steps the SNR up until BLER <=
--target-bler on a calibration call, so every bulk run sits in its waterfall
with a realistic early-termination iteration mix and a countable error
number), then runs its block budget through the full chain (encode ->
modulate -> AWGN -> exact LLR demod -> decode -> CRC gating) with the
layered normalized min-sum kernel.

Results checkpoint per entry to --out, so a crashed or interrupted campaign
resumes by skipping completed entries (the reference's append-per-point
results convention, plot_BLER_vs_SNR.m:165, at campaign scale).  On several
GPUs the same command fans out over every rank (``torchrun`` or
``parallel/launcher.py``): the skip is decided on rank 0 and broadcast, the
calibration and the loops read only all-reduced counters, and only rank 0
writes.

Example:  python -m ldpc_3gpp_tpu_torch.tools.pod_campaign               # full matrix
          python -m ldpc_3gpp_tpu_torch.tools.pod_campaign --scale 0.01  # 1% smoke run
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import zlib
from typing import Optional

#: the port's own output; never under golden/ (the JAX package's goldens)
DEFAULT_OUT = os.path.join("results", "torch", "pod_campaign.json")


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str
    BG: int
    A: int
    rate: float
    modulation: str
    blocks: int  # transport-block budget at --scale 1.0
    esn0_start: float  # calibration sweep start (dB)


# Matrix: both base graphs, every modulation the reference supports
# (BPSK through 256QAM), small/large A, single/multi code block, low/high
# rate, small Z through Z=384.  Budgets weight fast configurations so the
# campaign lands >= 1e9 code blocks.
MATRIX = (
    Entry("bg2_a100_r13_bpsk", 2, 100, 1 / 3, "BPSK", 50_000_000, -2.0),
    Entry("bg2_a100_r12_qpsk", 2, 100, 1 / 2, "QPSK", 300_000_000, 2.0),
    Entry("bg2_a308_r15_qpsk", 2, 308, 1 / 5, "QPSK", 150_000_000, -1.0),
    Entry("bg2_a640_r13_16qam", 2, 640, 1 / 3, "16QAM", 120_000_000, 4.0),
    Entry("bg2_a1500_r12_64qam", 2, 1500, 1 / 2, "64QAM", 80_000_000, 9.0),
    Entry("bg2_a3842_r13_qpsk", 2, 3842, 1 / 3, "QPSK", 50_000_000, 0.0),
    Entry("bg1_a4000_r12_16qam", 1, 4000, 1 / 2, "16QAM", 80_000_000, 5.0),
    Entry("bg1_a8424_r13_qpsk", 1, 8424, 1 / 3, "QPSK", 70_000_000, 0.0),
    # BG1 multi-code-block: C=3 CBs of Z=320 per transport block
    Entry("bg1_a20004_r12_16qam", 1, 20004, 1 / 2, "16QAM", 20_000_000, 5.0),
    Entry("bg1_a8424_r23_64qam", 1, 8424, 2 / 3, "64QAM", 60_000_000, 10.0),
    Entry("bg1_a8424_r89_256qam", 1, 8424, 8 / 9, "256QAM", 30_000_000, 19.0),
    Entry("bg1_a1000_r12_256qam", 1, 1000, 1 / 2, "256QAM", 30_000_000, 14.0),
)


def auto_batch(A: int) -> int:
    """Per-rank batch sized so batch*A ~ 4M info bits.

    A small-A chain is bound by fixed per-step costs (launches, host
    decisions) at batch 512, so it doubles the batch up to 8,192 while
    batch*A stays under 4M info bits; a large-A chain gains nothing past 512
    and pays device memory.
    """
    b = 512
    while b < 8192 and b * A < 4_000_000:
        b *= 2
    return b


def build_params(e: Entry):
    from ..ops.modulation import Q_M
    from ..spec.params import LDPCParams

    qm = Q_M[e.modulation]
    G = round(e.A / e.rate / qm) * qm
    return LDPCParams(BG=e.BG, A=e.A, G=G, Q_m=qm)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ldpc_3gpp_tpu_torch.tools.pod_campaign")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every block budget (0.01 = smoke run)")
    ap.add_argument("--target-bler", type=float, default=1.5e-2)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--batch-per-device", type=int, default=0,
                    help="0 = auto_batch(A) per config")
    ap.add_argument("--steps-per-call", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None, help="run a single entry by name")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the rank's GPU) or 'cpu' (plain versions)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..parallel.launcher import init_distributed

    # NCCL takes CUDA tensors only: a CPU run sums its counters under gloo
    owns_group = init_distributed(backend="gloo" if args.device == "cpu" else None)
    try:
        return _run(args)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _load_results(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f).get("configs", {})


def _run(args) -> dict:
    from ..models.chain import ChainConfig
    from ..parallel.launcher import decided_on_primary, is_primary, world_size
    from ..parallel.montecarlo import MonteCarlo
    from ..utils.rng import make_generator

    entries = [e for e in MATRIX if args.only in (None, e.name)]
    # fail fast: every parameter set must resolve before any long run starts
    all_params = {e.name: build_params(e) for e in entries}
    primary = is_primary()
    # the checkpoint is read on rank 0 and broadcast: every rank skips the
    # same entries
    results = decided_on_primary(lambda: _load_results(args.out))
    devices = world_size()

    def flush():
        done = [r for r in results.values() if "bler" in r]
        grand = {
            "transport_blocks": sum(r["blocks"] for r in done),
            "code_blocks": sum(r["code_blocks"] for r in done),
            "block_errors": sum(r["block_errors"] for r in done),
            "elapsed_s": round(sum(r["elapsed_s"] for r in done), 1),
        }
        if not primary:
            return grand
        payload = {
            "description": "Campaign Monte-Carlo (BASELINE config #5): full "
            "BG1+BG2 x BPSK..256QAM matrix at per-config calibrated operating "
            "points, layered normalized min-sum kernel, full chain, counters "
            "summed over every rank (PyTorch/CUDA port).",
            "devices": devices,
            "iterations_budget": args.iterations,
            "grand_total": grand,
            "configs": results,
        }
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out + ".tmp", "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(args.out + ".tmp", args.out)
        return grand

    def say(text):
        if primary:
            print(text, flush=True)

    for e in entries:
        if results.get(e.name, {}).get("bler") is not None and args.only is None:
            say(f"[{e.name}] already complete, skipping")
            continue
        p = all_params[e.name]
        budget = max(1, int(e.blocks * args.scale))
        cfg = ChainConfig(
            params=p, modulation=e.modulation, iterations=args.iterations,
            algorithm="min-sum", backend="auto", schedule="layered",
        )
        bpd = args.batch_per_device or auto_batch(e.A)
        mc = MonteCarlo(cfg, batch_per_device=bpd, steps_per_call=args.steps_per_call,
                        device=args.device)
        # zlib.crc32, not hash(): str hashing is salted per process, and the
        # campaign seed must be reproducible across runs/resumes; the one
        # generator serves the calibration and the bulk run, folded per rank
        generator = make_generator((args.seed ^ zlib.crc32(e.name.encode())) % 2**31,
                                   args.device)

        # --- calibrate the operating point ---
        # Coarse: step +0.5 dB until BLER <= target.  Steep waterfalls can
        # jump from >target straight past zero errors in one coarse step,
        # so refine back down in 0.25 dB steps while the point looks too
        # clean (< target/30) — every bulk run should land inside its
        # waterfall with countable errors and a realistic iteration mix.
        def measure(esn0_db):
            c = mc.run(generator, esn0_db)
            return c["block_errors"] / c["blocks"]

        esn0 = e.esn0_start
        t_cal = time.time()
        for _ in range(40):
            bler = measure(esn0)
            if bler <= args.target_bler:
                break
            esn0 += 0.5
        for _ in range(6):
            if bler > args.target_bler / 30:
                break
            down = measure(esn0 - 0.25)
            if down > args.target_bler:
                break
            esn0 -= 0.25
            bler = down
        say(f"[{e.name}] Z={p.Z_c} C={p.C} G={p.G} batch={bpd}: operating "
            f"point {esn0:+.2f} dB (cal BLER {bler:.2e}, {time.time() - t_cal:.0f}s)")

        # --- bulk run ---
        totals = {"blocks": 0, "block_errors": 0, "bit_errors": 0, "iterations": 0}
        t0 = time.time()
        last = t0
        while totals["blocks"] < budget:  # all-reduced: every rank agrees
            rem = -(-(budget - totals["blocks"]) // mc.blocks_per_run)
            c = mc.run_pipelined(generator, esn0, min(16, max(1, rem)))
            for k in totals:
                totals[k] += c[k]
            if primary and time.time() - last > 30:
                rate = totals["blocks"] / (time.time() - t0)
                say(f"[{e.name}] {totals['blocks']:,}/{budget:,} blocks, "
                    f"{totals['block_errors']:,} errors, {rate:,.0f} TB/s")
                last = time.time()
        dt = time.time() - t0
        results[e.name] = {
            "BG": e.BG, "A": e.A, "G": p.G, "Z": p.Z_c, "C": p.C,
            "modulation": e.modulation, "esn0_db": round(esn0, 2),
            "blocks": totals["blocks"],
            "code_blocks": totals["blocks"] * p.C,
            "block_errors": totals["block_errors"],
            "bit_errors": totals["bit_errors"],
            "bler": totals["block_errors"] / totals["blocks"],
            "mean_iterations_per_cb": totals["iterations"] / (totals["blocks"] * p.C),
            "elapsed_s": round(dt, 1),
            "transport_blocks_per_sec": round(totals["blocks"] / dt, 1),
            "info_mbps": round(totals["blocks"] / dt * e.A / 1e6, 2),
        }
        grand = flush()
        say(f"[{e.name}] done: BLER {results[e.name]['bler']:.3e}, "
            f"{results[e.name]['transport_blocks_per_sec']:,.0f} TB/s, "
            f"{dt:.0f}s   (campaign: {grand['code_blocks']:,} CBs)")

    grand = flush()
    say(json.dumps(grand, indent=1))
    return {"grand_total": grand, "configs": results}


if __name__ == "__main__":
    main()
