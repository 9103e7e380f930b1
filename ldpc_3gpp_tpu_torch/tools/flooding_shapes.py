"""Block size of the flooding kernels on the card.

``ops/decoder_cuda.py`` chooses it by a rule on shape and batch
(``flooding_threads``, read through ``launch_shape``); no result depends on
it.  ``shape_table`` times the kernel at the rule's choice and at the
alternatives (``decode``'s internal ``_threads``), on the same LLRs, for
several seeds of LLRs, and checks that every alternative returns the rule's
bits, parity flags and iteration counts:

- ``snr_vs_a``'s launches with the reference's defaults (BG1 R=1/3 QPSK, 256
  codewords, sum-product, 50 iterations) at A=1000 (Z=48, -1.0 dB) and
  A=8000 (Z=384, -1.6 dB, a cluster of three blocks per codeword);
- config #1's launch of ``bler_vs_snr`` (BG2 A=100 R=1/2, Z=20, 2,048
  codewords, min-sum, 50 iterations, 2.0 dB), one codeword per block and
  with the packed kernel at 2, 4 and 8 codewords per block, with early
  termination and run to the budget (every codeword 50 sweeps: the kernels'
  cost per sweep, without the stragglers);
- P2's launch (BG2 A=3842, Z=208, 2,048 codewords, sum-product, 8
  iterations, 1.0 dB).

    python3 -m ldpc_3gpp_tpu_torch.tools.flooding_shapes [seeds]

prints one JSON line per case and seed with the card's name and power limit
(seeds: a comma-separated list, default 0,1,2).  Needs a CUDA device.
"""
from __future__ import annotations

import functools
import json
import sys

import torch

from ..ops import decoder_cuda
from ..spec.params import LDPCParams
from ..utils.profiling import time_ms
from .op_rates import card_name_and_power_limit
from .small_z import noisy_llrs

_KW = dict(schedule="flooding", channel_format="d", output_format="sys")
SUM_PRODUCT_50 = dict(_KW, algorithm="sum-product", iterations=50)
# (case, fields, Es/N0 dB, codewords, decode keywords, block sizes timed
# beside the rule's)
CASES = (
    ("snr_vs_a A=1000", dict(BG=1, A=1000, G=3000, Q_m=2), -1.0, 256, SUM_PRODUCT_50,
     (128, 256, 512, 1024)),
    ("snr_vs_a A=8000", dict(BG=1, A=8000, G=24000, Q_m=2), -1.6, 256, SUM_PRODUCT_50,
     (512, 1024)),
    ("config #1", dict(BG=2, A=100, G=200, Q_m=2), 2.0, 2048,
     dict(_KW, algorithm="min-sum", iterations=50), (64, 128, 256, 512, 1024)),
    *((f"config #1, P={P}", dict(BG=2, A=100, G=200, Q_m=2), 2.0, 2048,
       dict(_KW, algorithm="min-sum", iterations=50, codewords_per_block=P), threads)
      for P, threads in ((2, (256, 512)), (4, (256, 512, 1024)), (8, (512, 1024)))),
    *((f"config #1, budget, P={P}", dict(BG=2, A=100, G=200, Q_m=2), 2.0, 2048,
       dict(_KW, algorithm="min-sum", iterations=50, codewords_per_block=P,
            early_termination=False), threads)
      for P, threads in ((1, (128, 512)), (4, (512,)))),
    ("P2", dict(BG=2, A=3842, G=11526, Q_m=2), 1.0, 2048,
     dict(_KW, algorithm="sum-product", iterations=8), (256, 512, 1024)),
)
SEEDS = (0, 1, 2)


def _same(a, b) -> bool:
    return (torch.equal(a.bits, b.bits) and torch.equal(a.parity_ok, b.parity_ok)
            and torch.equal(a.iterations, b.iterations))


def case_llrs(params, n: int, esn0_db: float, seed: int, device):
    """A case's 'd' LLRs for one seed of LLRs."""
    return noisy_llrs(params, n, esn0_db, 300 + params.Z_c + 1000 * seed, device)


def time_launches(params, llr, kw, launches: dict, reps: int, device) -> dict:
    """``decoder_cuda.decode`` of the same LLRs at each launch of
    ``launches`` ({label: decode keywords beside ``kw``}, the rule's launch
    first): {label: {"result", "ms", "equal"}}, ms the mean of
    ``reps`` launches after the one whose result is kept and one warm-up
    (``utils/profiling.py::time_ms``: CUDA events on the card, the host
    clock on the CPU), ``equal`` whether the bits, parity flags and iteration
    counts equal the first launch's."""
    out = {}
    for label, extra in launches.items():
        fn = functools.partial(decoder_cuda.decode, params, llr, **kw, **extra)
        res = fn()
        first = next(iter(out.values()))["result"] if out else res
        out[label] = dict(result=res, ms=time_ms(fn, reps, warmup=1, device=device),
                          equal=_same(res, first))
    return out


def shape_table(device, cases=CASES, seeds=SEEDS, reps: int = 10):
    """One record per case and seed: ms of the rule's launch and of each
    alternative block size, and whether all of them agree."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for case, fields, esn0_db, n, kw, threads_list in cases:
        params = LDPCParams(**fields)
        rule = decoder_cuda.launch_shape(params, n, "flooding",
                                         kw.get("codewords_per_block", 0), sms)
        threads = [rule["threads"], *sorted(set(threads_list) - {rule["threads"]})]
        for seed in seeds:
            d = case_llrs(params, n, esn0_db, seed, device)
            timed = time_launches(params, d, kw, {f"threads={T}": dict(_threads=T)
                                                  for T in threads}, reps, device)
            ref = timed[f"threads={rule['threads']}"]["result"]
            ms = {label: r["ms"] for label, r in timed.items()}
            equal = all(r["equal"] for r in timed.values())
            best = min(ms, key=ms.get)
            rows.append({
                "case": case, "seed": seed, "bg": params.BG, "A": params.A,
                "Z": params.Z_c, "n": n, "algorithm": kw["algorithm"],
                "iterations": kw["iterations"], "esn0_db": esn0_db,
                "mean_iterations": float(ref.iterations.float().mean()),
                "max_iterations": int(ref.iterations.max()),
                "rule": rule, "ms": ms, "fastest": best,
                "rule_over_fastest": ms[f"threads={rule['threads']}"] / ms[best],
                "equal_to_the_rule": equal,
            })
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("flooding_shapes: no CUDA device; this tool measures a GPU", file=sys.stderr)
        return 1
    seeds = tuple(int(s) for s in argv[0].split(",")) if argv else SEEDS
    device = torch.device("cuda", 0)
    card = card_name_and_power_limit()
    ok = True
    for row in shape_table(device, seeds=seeds):
        ok &= row["equal_to_the_rule"]
        print(json.dumps({**row, "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
