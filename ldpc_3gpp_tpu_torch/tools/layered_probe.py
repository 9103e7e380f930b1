"""What holds the layered min-sum kernel back, by taking its parts away.

``ncu`` cannot profile on the machine with the card, so this tool measures
the split that its stall reasons would give by building variants of
``csrc/ldpc_layered.cu`` that leave one part of the work out, and timing
each at the flagship shape (BG1 A=8424 Z=384, 1,024 codewords at 1.0 dB,
'd' in, 'sys' out, min-sum):

- ``kernel``: the kernel as it is;
- ``lookahead_2``: the words of the row after next loaded ahead too
  (LOOKAHEAD 2, not 1: a kernel in its own right, whose results must equal
  the kernel's);
- ``no_scratch``: no message word is loaded or stored (every sweep reads
  zero messages);
- ``no_row_barrier``: no barrier between rows (rows race on the totals);
- ``no_scratch_no_barrier``: neither.

The three last compute wrong bits; only their times mean anything, so every
variant is timed run to a budget of 12 sweeps (V4-layered: the same work
whatever the bits), and the kernel and ``lookahead_2`` also with early
termination (V1).  The variants are written to and built in
``build/ldpc_3gpp_tpu_torch/probe/`` with the package's nvcc flags, one
``nvcc`` each, all started together, and launched through ``decode``'s
internal ``_lib``.

    python3 -m ldpc_3gpp_tpu_torch.tools.layered_probe

prints one JSON line with the card's name and power limit, each variant's
registers, stack and spills (``ptxas -v``) and its times (five means of
several launches each, CUDA events).  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from .. import kernels_build
from ..ops import decoder_cuda
from ..spec.params import LDPCParams
from .op_rates import card_name_and_power_limit, time_ms
from .small_z import noisy_llrs

PROBE_DIR = os.path.join(kernels_build.BUILD_DIR, "probe")
SOURCE = "ldpc_layered.cu"
HEADER = "ldpc_bp.cuh"

# (file, text in the source, its replacement, occurrences)
_LOOKAHEAD_2 = (SOURCE, "constexpr int LOOKAHEAD = 1;", "constexpr int LOOKAHEAD = 2;", 1)
_NO_LOAD = (SOURCE, "    if (!first || wrap)\n      q[LOOKAHEAD - 1] =",
            "    if (false)\n      q[LOOKAHEAD - 1] =", 1)
_NO_STORE = (HEADER, "  store_row_msgs<MSG>(w, L, m1s, m2s, signs | (idx << MSG_IDX_SHIFT));\n",
             "", 1)
_NO_BARRIER = (SOURCE, "a.offset_rule, a.beta);\n        }\n      }\n      __syncthreads();\n",
               "a.offset_rule, a.beta);\n        }\n      }\n", 2)
VARIANTS = {
    "kernel": (),
    "lookahead_2": (_LOOKAHEAD_2,),
    "no_scratch": (_NO_LOAD, _NO_STORE),
    "no_row_barrier": (_NO_BARRIER,),
    "no_scratch_no_barrier": (_NO_LOAD, _NO_STORE, _NO_BARRIER),
}
FLAGSHIP = dict(BG=1, A=8424, G=25272, Q_m=2)
DECODE_KW = dict(iterations=12, algorithm="min-sum", channel_format="d", output_format="sys")


def write_variant(variant: str) -> str:
    """The variant's sources under PROBE_DIR; returns its .cu path."""
    out_dir = os.path.join(PROBE_DIR, variant)
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name in (SOURCE, HEADER):
        with open(os.path.join(kernels_build.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    for name, old, new, count in VARIANTS[variant]:
        if texts[name].count(old) != count:
            raise RuntimeError(f"{variant}: {old!r} is not in {name} {count} times")
        texts[name] = texts[name].replace(old, new)
    for name, text in texts.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    return os.path.join(out_dir, SOURCE)


def build_variants(variants=tuple(VARIANTS)) -> dict:
    """Build every variant (one nvcc each, all started together); returns
    {variant: (declared library, ptxas record of the one-codeword min-sum
    float32 kernel)}."""
    procs = {}
    for v in variants:
        src = write_variant(v)
        lib = src[:-3] + ".so"
        cmd = [kernels_build._nvcc(), *kernels_build.NVCC_FLAGS, "-o", lib, src]
        procs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    out = {}
    for v, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        out[v] = (decoder_cuda.declare(ctypes.CDLL(lib), "ldpc_layered"), _ptxas(log))
    return out


def _ptxas(log: str) -> dict:
    """Registers, stack and spills of ldpc_layered_kernel<false, float>."""
    rec, inside = {}, False
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", ln)
        if m:
            inside = m.group(1).startswith("_Z19ldpc_layered_kernelILb0EfE")
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m:
            rec.update(stack=int(m[1]), spill_stores=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rec["registers"] = int(m[1])
    return rec


def probe(device, variants=tuple(VARIANTS), reps: int = 10) -> dict:
    """Each variant's times at the flagship shape: run to a budget of 12
    sweeps for all, with early termination for the two that compute the
    kernel's bits (and whose results are checked equal)."""
    libs = build_variants(variants)
    params = LDPCParams(**FLAGSHIP)
    d = noisy_llrs(params, 1024, 1.0, 21, device)
    out = {}
    reference = None
    for v, (lib, ptxas) in libs.items():
        budget = dict(DECODE_KW, early_termination=False)
        rec = dict(ptxas, budget_12_ms=[
            time_ms(lambda: decoder_cuda.decode(params, d, _lib=lib, **budget), reps)
            for _ in range(5)])
        if v in ("kernel", "lookahead_2"):
            res = decoder_cuda.decode(params, d, _lib=lib, **DECODE_KW)
            torch.cuda.synchronize()
            got = (res.bits, res.parity_ok, res.iterations)
            if reference is None:
                reference = got
            elif not all(torch.equal(a, b) for a, b in zip(got, reference)):
                raise AssertionError(f"{v} differs from the kernel")
            rec["early_termination_ms"] = [
                time_ms(lambda: decoder_cuda.decode(params, d, _lib=lib, **DECODE_KW), reps)
                for _ in range(5)]
            rec["mean_iterations"] = float(res.iterations.float().mean())
        out[v] = rec
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("layered_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": card_name_and_power_limit(), "variants": probe(dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
