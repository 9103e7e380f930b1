"""What holds the cluster form of the flooding kernel back, by taking its
parts away.

``ncu`` cannot profile on the machine with the card, so this tool measures
the split of ``ldpc_flooding_cluster_kernel``'s time (``csrc/ldpc_flooding.cu``)
by building variants of the source that leave one part of the work out, and
timing each at ``snr_vs_a``'s A=8000 launch (BG1 A=8000 G=24000 Z=384, a
cluster of 3 blocks per codeword, sum-product, -1.6 dB, 50 iterations, 'd'
in, 'sys' out) at 256 codewords (one call of the sweep) and at 8,192 (a
step of the ``snr_vs_a_a8000_b8192`` benchmark cell).  The variants:

- ``kernel``: the kernel as it is;
- ``local_reads``: every access to distributed shared memory (DSMEM) made
  an access to the block's own shared memory at the same offset (the
  message phase's reads of the totals and of the messages, and its stores
  of the messages);
- ``local_totals``: the same for the reads of the totals only;
- ``local_messages``: the same for the messages' reads and stores only;
- ``own_rank_plain``: the block's own column owner reached through a plain
  shared pointer, the other ranks through the cluster mapping (a kernel in
  its own right, whose results must equal the kernel's);
- ``no_vote``: no block vote and no DSMEM store of it (every codeword runs
  on);
- ``no_second_sync``: no ``cluster.sync()`` after the column phase (the
  next message phase races the column phase).

The column phase reads only its own block's shared memory (each column's
messages live with its total), so no variant takes its reads apart; the
form before that, whose column phase read other blocks' messages, was taken
apart by this tool with ``local_columns`` in their place (PERF.md §6).
Every variant but ``own_rank_plain`` computes wrong bits; only their times
mean anything, so every variant is timed run to the budget (the same work
whatever the bits), and those that compute the kernel's bits also with early
termination (their results checked equal).  No variant reads another block's
shared memory after the last ``cluster.sync()``.  The variants are written to
and built in ``build/ldpc_3gpp_tpu_torch/probe/flooding/`` with the package's
nvcc flags, one ``nvcc`` each, all started together (a variant that does not
build is reported, not fatal), and launched through ``decode``'s internal
``_lib``.

    python3 -m ldpc_3gpp_tpu_torch.tools.flooding_probe [256] [8192]

prints one JSON line per batch (default: both) with the card's name and
power limit, each variant's registers, stack and spills (``ptxas -v``) and
its times (means of several launches each, CUDA events).  Needs a CUDA
device and nvcc.
"""
from __future__ import annotations

import json
import sys

import torch

from ..ops import decoder_cuda
from ..spec.params import LDPCParams
from . import layered_probe
from .op_rates import card_name_and_power_limit, time_ms
from .small_z import noisy_llrs

SOURCE = "ldpc_flooding.cu"
HEADER = layered_probe.HEADER
FAMILY = "flooding"

# (file, text in the source, its replacement, occurrences)
_OWNER = ("    return cg::this_cluster().map_shared_rank(slots, "
          "(unsigned)(ed.x >> OWNER_SHIFT));\n")
_LOCAL_READS = (SOURCE, _OWNER, "    return slots;\n", 1)
_LOCAL_TOTALS = (SOURCE, "    return owner(ed)[(ed.x & OFFSET_MASK) + rot(z, ed.y, Z)];\n",
                 "    return slots[(ed.x & OFFSET_MASK) + rot(z, ed.y, Z)];\n", 1)
_LOCAL_MESSAGES = (SOURCE, "    return owner(ed)[ed.z + rot(z, ed.y, Z)];\n",
                   "    return slots[ed.z + rot(z, ed.y, Z)];\n", 1)
_OWN_RANK_PLAIN = (SOURCE, _OWNER,
                   "    const unsigned r = (unsigned)(ed.x >> OWNER_SHIFT);\n"
                   "    return r == cg::this_cluster().block_rank()\n"
                   "               ? slots : cg::this_cluster().map_shared_rank(slots, r);\n", 1)
_NO_VOTE = (SOURCE,
            "    const int vote = __syncthreads_or(bad & SIGN_BIT) ? 1 : 0;\n"
            "    if (t < CS) *cluster.map_shared_rank(votes + b, (unsigned)t) = vote;\n",
            "    asm volatile(\"\" ::\"r\"(bad));\n", 1)
_NO_VOTE_READ = (SOURCE,
                 "    int any_bad = 0;\n    for (int q = 0; q < CS; ++q) any_bad |= votes[q];\n",
                 "    const int any_bad = 1;\n", 1)
_NO_SECOND_SYNC = (SOURCE, "        slots[i] = __fadd_rn(v, sum);\n      }\n    }\n"
                   "    cluster.sync();\n  }\n",
                   "        slots[i] = __fadd_rn(v, sum);\n      }\n    }\n  }\n", 1)
VARIANTS = {
    "kernel": (),
    "local_reads": (_LOCAL_READS,),
    "local_totals": (_LOCAL_TOTALS,),
    "local_messages": (_LOCAL_MESSAGES,),
    "own_rank_plain": (_OWN_RANK_PLAIN,),
    "no_vote": (_NO_VOTE, _NO_VOTE_READ),
    "no_second_sync": (_NO_SECOND_SYNC,),
}
EXACT = ("kernel", "own_rank_plain")  # the variants that compute the kernel's bits
ENTRY = "_Z28ldpc_flooding_cluster_kernelILb1ELb0EE"  # <sum-product, float32>
SHAPE = dict(BG=1, A=8000, G=24000, Q_m=2)
ESN0_DB = -1.6
DECODE_KW = dict(iterations=50, algorithm="sum-product", schedule="flooding",
                 channel_format="d", output_format="sys")
BATCHES = (256, 8192)
# launches per mean and means per variant, by batch
REPS = {256: (10, 5), 8192: (2, 3)}


def write_variant(variant: str) -> str:
    """The variant's sources under the probe directory; returns its .cu
    path."""
    return layered_probe.write_sources(variant, VARIANTS[variant], FAMILY, (SOURCE, HEADER))


def probe(device, batches=BATCHES) -> dict:
    """{batch: {variant: record}}: each variant's ptxas record and times at
    the A=8000 launch, run to the budget, and for the exact variants also
    with early termination (results checked equal to the kernel's)."""
    libs = layered_probe.build_sources(
        {v: write_variant(v) for v in VARIANTS}, "ldpc_flooding", ENTRY)
    params = LDPCParams(**SHAPE)
    launch = decoder_cuda.launch_shape(params, max(batches), "flooding")
    if launch["layout"] < 2:
        raise AssertionError(f"the A=8000 launch is not a cluster: {launch}")
    budget = dict(DECODE_KW, early_termination=False)
    out = {}
    for n in batches:
        d = noisy_llrs(params, n, ESN0_DB, 21, device)
        reps, means = REPS.get(n, (2, 3))
        rows, reference = {}, None
        for v, (lib, ptxas) in libs.items():
            if lib is None:
                rows[v] = ptxas
                continue
            rec = dict(ptxas, budget_ms=[
                time_ms(lambda: decoder_cuda.decode(params, d, _lib=lib, **budget), reps)
                for _ in range(means)], budget=DECODE_KW["iterations"])
            if v in EXACT:
                res = decoder_cuda.decode(params, d, _lib=lib, **DECODE_KW)
                torch.cuda.synchronize()
                got = (res.bits, res.parity_ok, res.iterations)
                if reference is None:
                    reference = got
                elif not all(torch.equal(a, b) for a, b in zip(got, reference)):
                    raise AssertionError(f"{v} differs from the kernel")
                rec["early_termination_ms"] = [
                    time_ms(lambda: decoder_cuda.decode(params, d, _lib=lib, **DECODE_KW),
                            reps) for _ in range(means)]
                rec["mean_iterations"] = float(res.iterations.float().mean())
            rows[v] = rec
        out[n] = dict(codewords=n, launch=decoder_cuda.launch_shape(params, n, "flooding"),
                      variants=rows)
        del d
    return out


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    batches = tuple(int(a) for a in args) or BATCHES
    if not torch.cuda.is_available():
        print("flooding_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name_and_power_limit()
    for n, rec in probe(dev, batches).items():
        print(json.dumps({"card": card, "kernel": "ldpc_flooding_cluster_kernel<true, false>",
                          "shape": dict(SHAPE, esn0_db=ESN0_DB, **DECODE_KW), **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
