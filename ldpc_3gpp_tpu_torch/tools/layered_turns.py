"""Two or more sources of the layered kernel, built side by side and timed in
turns on one card.

``time_kernels.py`` compares two checkouts through their own packages; this
tool compares sources of ``csrc/ldpc_layered.cu`` (each a directory holding
``ldpc_layered.cu`` and ``ldpc_bp.cuh``, for example the ``csrc/`` of a
parent unpacked with ``git archive``) through ``layered_probe.decode_build``,
which they must share the decode entry of.  For each source it builds one
library with the package's nvcc flags (one nvcc each, all started together)
and records the min-sum kernel's blocks per SM at the flagship shape; then:

- every source but the first against the plain version, tolerance 0, at
  small shapes (BG1 Z=3, 5, 20 and BG2 Z=15, 20, 52, 384, 64 codewords at
  1.0 dB; one codeword per block, and four at Z <= 32): min-sum with early
  termination 'd'/'sys',
  offset-min-sum run to budget, bfloat16 messages with an alpha schedule,
  offset-min-sum with beta 0.5 in the natural order;
- at the flagship shape (BG1 A=8424 Z=384, 1.0 dB, 12 iterations, 'd' in,
  'sys' out) V1, V4-layered (run to budget), V6-layered, V5 and V1'
  (offset-min-sum) at 1,024 codewords, V1 and V4-layered at 32,768 (the
  ``flagship_headline`` cell's step), every source's bits, parity flags and
  iterations equal to the first's; V2 (layered sum-product at P3's shape)
  and the small-Z launches too: V7-layered (config #1's call, BG2 A=100
  Z=20, 2,048 codewords at 2.0 dB, four codewords per block), V1-z20 (the
  same with one), V7-layered@65536 (65,536 codewords) and V7-layered-z8
  (BG2 A=32 Z=8, 16,384 codewords), the last two at the codewords per block
  of this package's rule, V7-layered@65536 also with 8;
- each row timed in turns, the sources forwards then backwards (for two:
  first, second, second, first; CUDA events, a mean of several launches).

    python3 -m ldpc_3gpp_tpu_torch.tools.layered_turns NAME=DIR NAME=DIR ...

prints one JSON line per row with the card's name and power limit.  Needs a
CUDA device and nvcc.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import torch

from ..ops import decoder_cuda
from ..spec.params import LDPCParams
from . import layered_probe
from .op_rates import card_name_and_power_limit, time_ms
from .roofline import require_equal
from .small_z import noisy_llrs, params_for_z

FOLDER = "turns"
CONFIG1, Z8 = layered_probe.CONFIG1, layered_probe.Z8
DS = dict(channel_format="d", output_format="sys")
V1 = dict(iterations=12, algorithm="min-sum", **DS)
# (row, code, Es/N0, codewords, launches per mean, decode arguments)
ROWS = (
    ("V1", layered_probe.FLAGSHIP, 1.0, 1024, 10, V1),
    ("V4-layered", layered_probe.FLAGSHIP, 1.0, 1024, 10, dict(V1, early_termination=False)),
    ("V6-layered", layered_probe.FLAGSHIP, 1.0, 1024, 10, dict(V1, message_dtype="bfloat16")),
    ("V5", layered_probe.FLAGSHIP, 1.0, 1024, 10, dict(V1, alpha_schedule=(0.65, 2))),
    ("V1'", layered_probe.FLAGSHIP, 1.0, 1024, 10, dict(V1, algorithm="offset-min-sum")),
    ("V1@32768", layered_probe.FLAGSHIP, 1.0, 32768, 2, V1),
    ("V4-layered@32768", layered_probe.FLAGSHIP, 1.0, 32768, 2,
     dict(V1, early_termination=False)),
    ("V2", dict(BG=2, A=2048, G=6144, Q_m=2), 2.0, 1024, 20,
     dict(iterations=8, algorithm="sum-product", **DS)),
    ("V7-layered", CONFIG1, 2.0, 2048, 20, dict(V1, codewords_per_block=4)),
    ("V1-z20", CONFIG1, 2.0, 2048, 20, dict(V1, codewords_per_block=1)),
    ("V7-layered@65536", CONFIG1, 2.0, 65536, 3, V1),
    ("V7-layered@65536-P8", CONFIG1, 2.0, 65536, 3, dict(V1, codewords_per_block=8)),
    ("V7-layered-z8", Z8, 2.0, 16384, 5, V1),
)
SMALL_CODES = ((1, 3), (1, 5), (1, 20), (2, 15), (2, 20), (2, 52), (2, 384))
SMALL_KW = (
    dict(iterations=12, algorithm="min-sum", **DS),
    dict(iterations=8, algorithm="offset-min-sum", early_termination=False, **DS),
    dict(iterations=12, algorithm="min-sum", message_dtype="bfloat16", alpha_schedule=(0.65, 2),
         **DS),
    dict(iterations=6, algorithm="offset-min-sum", beta=0.5, layer_order="natural", **DS),
)


def build(sources: dict) -> dict:
    """{name: declared library} for {name: directory}; raises where a
    source does not build."""
    paths = {}
    for name, src in sources.items():
        out = os.path.join(layered_probe.PROBE_DIR, FOLDER, name)
        os.makedirs(out, exist_ok=True)
        for f in (layered_probe.SOURCE, layered_probe.HEADER):
            shutil.copy(os.path.join(src, f), os.path.join(out, f))
        paths[name] = os.path.join(out, layered_probe.SOURCE)
    built = layered_probe.build_sources(paths, "ldpc_layered", "_Z")
    for name, (lib, rec) in built.items():
        if lib is None:
            raise RuntimeError(f"{name} does not build: {rec}")
    return {name: lib for name, (lib, _) in built.items()}


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    sources = dict(a.split("=", 1) for a in args)
    if len(sources) < 2:
        print("layered_turns: give two or more NAME=DIR sources", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("layered_turns: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name_and_power_limit()
    libs = build(sources)
    first, *others = libs
    flagship = LDPCParams(**layered_probe.FLAGSHIP)
    print(json.dumps({"card": card, "sources": sources, "blocks_per_sm": {
        name: lib.ldpc_layered_blocks_per_sm(0, 0, 1, flagship.Z_c, flagship.num_cols,
                                             flagship.num_rows, len(flagship.edges[0]))
        for name, lib in libs.items()}}), flush=True)
    cases = 0
    for bg, Z in SMALL_CODES:
        params = params_for_z(bg, Z)
        d = noisy_llrs(params, 64, 1.0, 3, dev)
        for kw in SMALL_KW:
            want = decoder_cuda.decode_plain(params, d, **kw)
            for name in others:
                for P in (1, 4) if Z <= 32 else (1,):
                    got = layered_probe.decode_build(libs[name], params, d, codewords_per_block=P,
                                                     **kw)
                    torch.cuda.synchronize()
                    require_equal(got, want, (name, bg, Z, P, kw))
                    cases += 1
    print(json.dumps({"card": card, "plain_cases_equal": cases, "tolerance": 0}), flush=True)
    order = list(libs) + list(reversed(libs))
    for row, fields, esn0_db, n, reps, kw in ROWS:
        params = LDPCParams(**fields)
        d = noisy_llrs(params, n, esn0_db, 21, dev)
        kw = dict(kw, codewords_per_block=decoder_cuda.resolve_codewords_per_block(
            params, n, "layered", kw.get("codewords_per_block", 0), kw["algorithm"]))
        ref = layered_probe.decode_build(libs[first], params, d, **kw)
        for name in others:
            got = layered_probe.decode_build(libs[name], params, d, **kw)
            torch.cuda.synchronize()
            require_equal(got, ref, (row, name))
        ms = {name: [] for name in libs}
        for name in order:
            lib = libs[name]
            ms[name].append(time_ms(lambda: layered_probe.decode_build(lib, params, d, **kw),
                                    reps))
        print(json.dumps({"card": card, "row": row, "codewords": n, "ms": ms,
                          "codewords_per_block": kw["codewords_per_block"],
                          "mean_iterations": float(ref.iterations.float().mean())}), flush=True)
        del d
    return 0


if __name__ == "__main__":
    sys.exit(main())
