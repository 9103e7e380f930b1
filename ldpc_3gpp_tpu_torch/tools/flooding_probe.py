"""What holds the flooding kernels back, by taking their parts away.

``ncu`` cannot profile on the machine with the card, so this tool measures
the split of a flooding kernel's time (``csrc/ldpc_flooding.cu``) by
building variants of the source that leave one part of the work out, or do
it another way, and timing each at the launch a benchmark cell makes.  Two
families:

- ``cluster``: ``ldpc_flooding_cluster_kernel`` at ``snr_vs_a``'s A=8000
  launch (BG1 A=8000 G=24000 Z=384, a cluster of 3 blocks per codeword,
  sum-product, -1.6 dB, 50 iterations, 'd' in, 'sys' out) at 256 codewords
  (one call of the sweep) and at 8,192 (a step of the
  ``snr_vs_a_a8000_b8192`` benchmark cell).  The variants:

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
  form before that, whose column phase read other blocks' messages, was
  taken apart by this tool with ``local_columns`` in their place (PERF.md
  §6).  No variant reads another block's shared memory after the last
  ``cluster.sync()``.

- ``one_block``: ``ldpc_flooding_kernel``'s min-sum instantiation (float32
  messages) at BASELINE config #1's launch (BG2 A=100 G=200 Z=20, normalized
  min-sum alpha 0.8125, 2.0 dB, 50 iterations, 'd' in, 'sys' out), one
  codeword per block and several blocks per SM, at 2,048 codewords (a
  ``bler_vs_snr`` call) and at 524,288 (a step of the
  ``config1_bg2_a100_b524288`` benchmark cell).  The variants:

  - ``kernel``: the kernel as it is;
  - ``no_column_phase``: the column phase left out (the totals never
    change);
  - ``no_message_stores``: the message phase computes, but a sink takes its
    ``deg`` stores of new messages;
  - ``no_rotation``: every edge at its check lane (no rotation);
  - ``channel_from_input``: the column phase reads the channel LLRs from
    the input, not from shared memory (exact);
  - ``max_deg_rows``: every row at MAX_DEG slots left at its degree, not
    unrolled to its own degree (exact);
  - ``no_vote``: the vote's ``__syncthreads_or`` made a plain barrier;
  - ``threads_64`` ... ``threads_256``: the kernel at other block sizes than
    the rule's, through ``decode``'s internal ``_threads`` (the largest
    batch only).

  The kernel's form before this one (each row's messages by check lane in
  row order, the column phase reading them through a column plan and a
  rotation, the channel LLRs re-read from the input, rows dealt in
  ascending order) was taken apart by this family with ``no_message_stores``,
  ``channel_on_chip``, ``no_rotation``, ``sorted_deal`` and ``no_vote``
  (PERF.md §6).

Every variant that is not exact computes wrong bits; only their times mean
anything, so every variant is timed run to the budget (the same work
whatever the bits), and those that compute the kernel's bits also with early
termination (their results checked equal).  Each record has the variant's
registers, stack and spills (``ptxas -v``) and its blocks per SM (the CUDA
runtime's occupancy at the launch).  The variants are written to and built
in ``build/ldpc_3gpp_tpu_torch/probe/<family folder>/`` with the package's
nvcc flags, one ``nvcc`` each, all started together (a variant that does not
build is reported, not fatal), and launched through ``decode``'s internal
``_lib``.

    python3 -m ldpc_3gpp_tpu_torch.tools.flooding_probe [256] [8192]
    python3 -m ldpc_3gpp_tpu_torch.tools.flooding_probe one_block [2048] [524288]

prints one JSON line per batch (default: the family's two) with the card's
name and power limit, each variant's records and its times (means of several
launches each, CUDA events).  Needs a CUDA device and nvcc.
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
FAMILY = "flooding"  # the cluster family's folder under the probe directory

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

# The one-codeword kernel at config #1's launch.
ONE_BLOCK_FOLDER = "flooding_one_block"
_OB_NO_COLUMN_PHASE = (
    SOURCE,
    "    // Column phase: totals = llr + the column's messages, plane by plane\n"
    "    // (ascending row order).\n"
    "    {\n      ItemWalk w(t, T, Z);\n"
    "      for (int i = t; i < nc * Z; i += T, w.next()) {\n",
    "    // Column phase: totals = llr + the column's messages, plane by plane\n"
    "    // (ascending row order).\n"
    "    {\n      ItemWalk w(t, T, Z);\n"
    "      for (int i = t; i < 0; i += T, w.next()) {\n", 1)
_OB_NO_MESSAGE_STORES = (
    SOURCE, "    if constexpr (kKeep)\n      g.msgs[at[i]] = m;\n    else\n      g.message(i, z) = m;\n",
    "    asm volatile(\"\" ::\"f\"(m));\n", 1)
_OB_NO_ROTATION = (SOURCE, "    return z >= ed.z ? z - Z : z;\n", "    return z - ed.w;\n", 1)
_OB_CHANNEL_FROM_INPUT = (
    SOURCE, "  float* chan = slots > nc + E ? msgs + E * Z : nullptr;  // the channel LLRs on chip\n",
    "  float* chan = nullptr;\n", 1)
_OB_MAX_DEG_ROWS = (SOURCE, "  switch (deg) {\n    FLOODING_ROW_EXACT(3)",
                    "  switch (0) {\n    FLOODING_ROW_EXACT(3)", 1)
_OB_NO_VOTE = (
    SOURCE, "    const bool pass = !__syncthreads_or(bad & SIGN_BIT);\n",
    "    asm volatile(\"\" ::\"r\"(bad));\n    __syncthreads();\n    const bool pass = false;\n", 1)
ONE_BLOCK_VARIANTS = {
    "kernel": (),
    "no_column_phase": (_OB_NO_COLUMN_PHASE,),
    "no_message_stores": (_OB_NO_MESSAGE_STORES,),
    "no_rotation": (_OB_NO_ROTATION,),
    "channel_from_input": (_OB_CHANNEL_FROM_INPUT,),
    "max_deg_rows": (_OB_MAX_DEG_ROWS,),
    "no_vote": (_OB_NO_VOTE,),
}
ONE_BLOCK_EXACT = ("kernel", "channel_from_input", "max_deg_rows")
ONE_BLOCK_ENTRY = "_Z20ldpc_flooding_kernelILb0ELb0EE"  # <min-sum, float32>
ONE_BLOCK_SHAPE = dict(BG=2, A=100, G=200, Q_m=2)
ONE_BLOCK_ESN0_DB = 2.0
ONE_BLOCK_DECODE_KW = dict(iterations=50, algorithm="min-sum", alpha=0.8125,
                           schedule="flooding", channel_format="d", output_format="sys")
ONE_BLOCK_BATCHES = (2048, 524288)
ONE_BLOCK_REPS = {2048: (10, 5), 524288: (2, 3)}
# block sizes timed beside the rule's, at the largest batch
ONE_BLOCK_THREADS = (64, 96, 128, 192, 256)

# family -> (variants, folder, exact variants, ptxas entry, code, Es/N0,
# decode arguments, batches, repetitions, block sizes, the layout the launch
# must have: a cluster (2 or more) or one block)
FAMILIES = {
    "cluster": (VARIANTS, FAMILY, EXACT, ENTRY, SHAPE, ESN0_DB, DECODE_KW, BATCHES, REPS, (),
                "cluster"),
    "one_block": (ONE_BLOCK_VARIANTS, ONE_BLOCK_FOLDER, ONE_BLOCK_EXACT, ONE_BLOCK_ENTRY,
                  ONE_BLOCK_SHAPE, ONE_BLOCK_ESN0_DB, ONE_BLOCK_DECODE_KW, ONE_BLOCK_BATCHES,
                  ONE_BLOCK_REPS, ONE_BLOCK_THREADS, "one_block"),
}


def write_variant(variant: str, family: str = "cluster") -> str:
    """The variant's sources under the probe directory (the family's
    folder); returns its .cu path."""
    variants, folder = FAMILIES[family][:2]
    return layered_probe.write_sources(variant, variants[variant], folder, (SOURCE, HEADER))


def _blocks_per_sm(lib, params, kw, threads) -> int:
    """Blocks of the variant's one-codeword launch that one SM holds."""
    bf16 = int(kw.get("message_dtype") == "bfloat16")
    return lib.ldpc_flooding_blocks_per_sm(
        decoder_cuda._RULE_CODES[kw["algorithm"]], bf16, 1, params.Z_c, params.num_cols,
        params.num_rows, len(params.edges[0]), decoder_cuda.LAYOUT_ON_CHIP, threads,
        decoder_cuda._block_slots(params, decoder_cuda.LAYOUT_ON_CHIP))


def probe(device, batches=None, family: str = "cluster") -> dict:
    """{batch: {variant: record}}: each variant's ptxas record and times at
    the family's launch, run to the budget, and for the exact variants also
    with early termination (results checked equal to the kernel's); for the
    one-block family also its blocks per SM, and the kernel at the other
    block sizes at the largest batch."""
    (variants, _, exact, entry, shape, esn0_db, decode_kw, default_batches, reps_by_n,
     thread_sizes, form) = FAMILIES[family]
    batches = tuple(batches or default_batches)
    libs = layered_probe.build_sources(
        {v: write_variant(v, family) for v in variants}, "ldpc_flooding", entry)
    params = LDPCParams(**shape)
    launch = decoder_cuda.launch_shape(params, max(batches), "flooding")
    if (launch["layout"] >= 2) != (form == "cluster") or launch["codewords_per_block"] != 1:
        raise AssertionError(f"the {family} launch has another form: {launch}")
    budget = dict(decode_kw, early_termination=False)
    out = {}
    for n in batches:
        d = noisy_llrs(params, n, esn0_db, 21, device)
        reps, means = reps_by_n.get(n, (2, 3))
        threads = decoder_cuda.launch_shape(params, n, "flooding")["threads"]

        def times(lib, kw, T=0):
            return [time_ms(lambda: decoder_cuda.decode(params, d, _lib=lib, _threads=T, **kw),
                            reps) for _ in range(means)]

        rows, reference = {}, None
        for v, (lib, ptxas) in libs.items():
            if lib is None:
                rows[v] = ptxas
                continue
            rec = dict(ptxas, budget_ms=times(lib, budget), budget=decode_kw["iterations"])
            if form == "one_block":
                rec["blocks_per_sm"] = _blocks_per_sm(lib, params, decode_kw, threads)
            if v in exact:
                res = decoder_cuda.decode(params, d, _lib=lib, **decode_kw)
                torch.cuda.synchronize()
                got = (res.bits, res.parity_ok, res.iterations)
                if reference is None:
                    reference = got
                elif not all(torch.equal(a, b) for a, b in zip(got, reference)):
                    raise AssertionError(f"{v} differs from the kernel")
                rec["early_termination_ms"] = times(lib, decode_kw)
                rec["mean_iterations"] = float(res.iterations.float().mean())
            rows[v] = rec
        if thread_sizes and n == max(batches) and libs["kernel"][0] is not None:
            lib = libs["kernel"][0]
            for T in thread_sizes:
                rows[f"threads_{T}"] = dict(
                    threads=T, blocks_per_sm=_blocks_per_sm(lib, params, decode_kw, T),
                    budget_ms=times(lib, budget, T), budget=decode_kw["iterations"])
        out[n] = dict(codewords=n, launch=decoder_cuda.launch_shape(params, n, "flooding"),
                      variants=rows)
        del d
    return out


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    family = args.pop(0) if args and args[0] in FAMILIES else "cluster"
    batches = tuple(int(a) for a in args)
    if not torch.cuda.is_available():
        print("flooding_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name_and_power_limit()
    _, _, _, entry, shape, esn0_db, decode_kw = FAMILIES[family][:7]
    kernel = {"cluster": "ldpc_flooding_cluster_kernel<true, false>",
              "one_block": "ldpc_flooding_kernel<false, false>"}[family]
    for n, rec in probe(dev, batches, family).items():
        print(json.dumps({"card": card, "family": family, "kernel": kernel,
                          "shape": dict(shape, esn0_db=esn0_db, **decode_kw), **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
