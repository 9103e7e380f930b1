"""What holds the layered kernels back, by taking their parts away.

``ncu`` cannot profile on the machine with the card, so this tool measures
the split that its stall reasons would give by building variants of
``csrc/ldpc_layered.cu`` that leave one part of the work out, and timing
each, 1,024 codewords, 'd' in, 'sys' out.  Two families:

- ``min-sum`` (V1) at the flagship shape (BG1 A=8424 Z=384, 1.0 dB, 12
  sweeps): ``kernel``, the kernel as it is; ``lookahead_2``, the words of
  the row after next loaded ahead too (LOOKAHEAD 2, not 1: a kernel in its
  own right, whose results must equal the kernel's); ``no_scratch``, no
  message word loaded or stored (every sweep reads zero messages);
  ``no_row_barrier``, no barrier between rows (rows race on the totals);
  ``no_scratch_no_barrier``, neither;
- ``sum-product`` (V2) at P3's shape (BG2 A=2048 Z=208, 2.0 dB, 8 sweeps):
  ``kernel``; ``max_deg_slots``, every row at MAX_DEG predicated slots (the
  row before the degree dispatch, whose results must equal the kernel's);
  ``no_scratch``, ``no_row_barrier`` and ``no_scratch_no_barrier`` as
  above.

The variants without scratch or barrier compute wrong bits; only their times
mean anything, so every variant is timed run to the budget (the same work
whatever the bits), and those that compute the kernel's bits also with early
termination.  The variants are written to and built in
``build/ldpc_3gpp_tpu_torch/probe/`` with the package's nvcc flags, one
``nvcc`` each, all started together (a variant that does not build is
reported, not fatal), and launched through ``decode``'s internal ``_lib``.

    python3 -m ldpc_3gpp_tpu_torch.tools.layered_probe [min-sum] [sum-product]

prints one JSON line per family (default: both) with the card's name and
power limit, each variant's registers, stack and spills (``ptxas -v``) and
its times (five means of several launches each, CUDA events).  Needs a CUDA
device and nvcc.
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

# The sum-product instantiation (V2) at P3's shape: its rows at MAX_DEG
# predicated slots (the row before the degree dispatch), its message round
# trip and its row barrier taken out.
_SP_MAX_DEG = (HEADER, "  switch (deg) {\n    SP_ROW_EXACT(3)",
               "  switch (0) {\n    SP_ROW_EXACT(3)", 1)
_SP_NO_LOAD = (HEADER, "      const float ve = first ? t : __fsub_rn(t, c2v[ed.z]);\n",
               "      const float ve = t;\n", 1)
_SP_NO_STORE = (HEADER, "      c2v[ed.z] = msg;\n", "", 1)
SP_VARIANTS = {
    "kernel": (),
    "max_deg_slots": (_SP_MAX_DEG,),
    "no_scratch": (_SP_NO_LOAD, _SP_NO_STORE),
    "no_row_barrier": (_NO_BARRIER,),
    "no_scratch_no_barrier": (_SP_NO_LOAD, _SP_NO_STORE, _NO_BARRIER),
}
P3 = dict(BG=2, A=2048, G=6144, Q_m=2)
SP_DECODE_KW = dict(iterations=8, algorithm="sum-product", channel_format="d",
                    output_format="sys")
# family -> (variants, code, Es/N0, kernel instantiation in ptxas's names,
# the variants that compute the kernel's bits)
FAMILIES = {
    "min-sum": (VARIANTS, FLAGSHIP, 1.0, DECODE_KW, "_Z19ldpc_layered_kernelILb0EfE",
                ("kernel", "lookahead_2")),
    "sum-product": (SP_VARIANTS, P3, 2.0, SP_DECODE_KW, "_Z19ldpc_layered_kernelILb1EfE",
                    ("kernel", "max_deg_slots")),
}


def write_variant(variant: str, family: str = "min-sum") -> str:
    """The variant's sources under PROBE_DIR (the sum-product family's in
    its own folder); returns its .cu path."""
    return write_sources(variant, FAMILIES[family][0][variant],
                         None if family == "min-sum" else family, (SOURCE, HEADER))


def write_sources(variant: str, patches, folder, names) -> str:
    """The files ``names`` of ``csrc/`` (the kernel's source first) with
    ``patches`` applied, under PROBE_DIR (in ``folder`` unless None) /
    ``variant``; returns the source's path.  Raises where a patch does not
    find its text exactly as often as it says."""
    out_dir = os.path.join(PROBE_DIR, *([] if folder is None else [folder]), variant)
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name in names:
        with open(os.path.join(kernels_build.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    for name, old, new, count in patches:
        if texts[name].count(old) != count:
            raise RuntimeError(f"{variant}: {old!r} is not in {name} {count} times")
        texts[name] = texts[name].replace(old, new)
    for name, text in texts.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    return os.path.join(out_dir, names[0])


def build_variants(family: str) -> dict:
    """Build every variant of ``family`` (one nvcc each, all started
    together); returns {variant: (declared library, ptxas record of the
    family's one-codeword float32 kernel)}."""
    return build_sources({v: write_variant(v, family) for v in FAMILIES[family][0]},
                         "ldpc_layered", FAMILIES[family][4])


def build_sources(sources: dict, name: str, entry: str) -> dict:
    """Build each {variant: .cu path} with the package's nvcc flags (one
    nvcc each, all started together); returns {variant: (library declared as
    kernel ``name``, ptxas record of the entry whose mangled name starts with
    ``entry``)}, or (None, the build's log) for a variant that does not
    build."""
    procs = {}
    for v, src in sources.items():
        lib = src[:-3] + ".so"
        cmd = [kernels_build._nvcc(), *kernels_build.NVCC_FLAGS, "-o", lib, src]
        procs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    out = {}
    for v, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:  # recorded; the other variants go on
            out[v] = (None, {"build_failed": log[-2000:]})
            continue
        out[v] = (decoder_cuda.declare(ctypes.CDLL(lib), name), _ptxas(log, entry))
    return out


def _ptxas(log: str, entry: str) -> dict:
    """Registers, stack and spills of the kernel whose mangled name starts
    with ``entry``."""
    rec, inside = {}, False
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", ln)
        if m:
            inside = m.group(1).startswith(entry)
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            rec.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rec["registers"] = int(m[1])
    return rec


def probe(device, family: str = "min-sum", reps: int = 10) -> dict:
    """Each variant's times at the family's shape, 1,024 codewords: run to
    the budget for all, with early termination for those that compute the
    kernel's bits (and whose results are checked equal)."""
    _, fields, esn0_db, kw, _, exact = FAMILIES[family]
    libs = build_variants(family)
    params = LDPCParams(**fields)
    d = noisy_llrs(params, 1024, esn0_db, 21, device)
    budget = dict(kw, early_termination=False)
    out = {}
    reference = None
    for v, (lib, ptxas) in libs.items():
        if lib is None:
            out[v] = ptxas
            continue
        rec = dict(ptxas, budget_ms=[
            time_ms(lambda: decoder_cuda.decode(params, d, _lib=lib, **budget), reps)
            for _ in range(5)], budget=kw["iterations"])
        if v in exact:
            res = decoder_cuda.decode(params, d, _lib=lib, **kw)
            torch.cuda.synchronize()
            got = (res.bits, res.parity_ok, res.iterations)
            if reference is None:
                reference = got
            elif not all(torch.equal(a, b) for a, b in zip(got, reference)):
                raise AssertionError(f"{v} differs from the kernel")
            rec["early_termination_ms"] = [
                time_ms(lambda: decoder_cuda.decode(params, d, _lib=lib, **kw), reps)
                for _ in range(5)]
            rec["mean_iterations"] = float(res.iterations.float().mean())
        out[v] = rec
    return out


def main(argv=None) -> int:
    families = (argv if argv is not None else sys.argv[1:]) or list(FAMILIES)
    if not torch.cuda.is_available():
        print("layered_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for family in families:
        print(json.dumps({"card": card_name_and_power_limit(), "family": family,
                          "variants": probe(dev, family)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
