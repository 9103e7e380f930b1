"""What holds the layered kernels back, by taking their parts away.

``ncu`` cannot profile on the machine with the card, so this tool measures
the split that its stall reasons would give by building variants of
``csrc/ldpc_layered.cu`` that leave one part of the work out, or do it
another way, and timing each, 'd' in, 'sys' out.  Two families:

- ``min-sum`` (V1, ``ldpc_layered_min_sum_kernel``) at the flagship shape
  (BG1 A=8424 Z=384, 1.0 dB, alpha 0.8125, 12 sweeps), at 1,024 codewords
  and at 32,768 (a step of the ``flagship_headline`` benchmark cell):

  - ``kernel``: the kernel as it is;
  - ``lookahead_2``: the words of the row after next loaded ahead too
    (LOOKAHEAD 2, not 1: a kernel in its own right, whose results must equal
    the kernel's);
  - ``no_scratch``: no message word loaded or stored (every sweep reads
    zero messages);
  - ``no_row_barrier``: no barrier between rows (rows race on the totals);
  - ``no_scratch_no_barrier``: neither;
  - ``group_barriers``: a barrier only where the next row shares a column
    with a row since the last barrier (exact: 32 barriers a sweep in place
    of 46 at BG1 in the reversed order; the flag rides in the ``w`` word of
    each row's last edge of the plan, ``row_groups``);
  - ``no_old_rebuild``: every old message taken as the row's ``m1s`` (its
    other words still loaded): the rebuild's arithmetic;
  - ``no_rotation``: every edge at its check lane: the address arithmetic;
  - ``linear_vs_tree``: the rows of more than 8 edges keep their two
    smallest magnitudes by a pairwise tree in place of the running
    tournament, ties to the lower edge (exact);
  - ``one_block_per_sm``: the dynamic shared memory padded above half the
    SM, so that one block runs per SM (exact): what the second block hides;
  - ``three_blocks``: the totals folded onto 26 columns and
    ``__launch_bounds__(384, 3)``: what a third block per SM would buy at
    56 registers, and whether that budget spills (wrong bits);
  - ``addresses_kept_all``: the rows of 19 edges keep their v_i and
    addresses in registers too, as the shorter rows do (exact);
  - ``rows_19_at_max_deg``: the rows of 19 edges at MAX_DEG predicated
    slots, not unrolled to 19 (exact);
  - ``no_opaque_asm``: without the empty asm statements that keep the words'
    pointer and alpha in registers across rows (exact);
  - ``rule_branch``: the rule a run-time branch in every row, as one
    instantiation for both rules would have it (exact);
  - ``unconditional_loads``: every row's words loaded, in sweep 0 too, and
    replaced by zeros there (exact);
  - ``words_l2_evict_last``, ``words_cg``: the words' loads and stores with
    half of their lines kept last in the L2 (``createpolicy``), or through
    the L2 only (``ld.global.cg``, ``st.global.cg``) (exact).

  The form before this one (the row of ``ldpc_bp.cuh``: each address
  computed and each edge record read in both passes, a ``first`` select per
  edge, the words' addresses rebuilt in 64 bits every row) was taken apart
  by the first eleven of these and ``addresses_kept`` (its form of
  ``addresses_kept_all``) (PERF.md §6);

- ``sum-product`` (V2) at P3's shape (BG2 A=2048 Z=208, 2.0 dB, 8 sweeps),
  1,024 codewords: ``kernel``; ``max_deg_slots``, every row at MAX_DEG
  predicated slots (the row before the degree dispatch, whose results must
  equal the kernel's); ``no_scratch``, ``no_row_barrier`` and
  ``no_scratch_no_barrier`` as above.

The variants that are not exact compute wrong bits; only their times mean
anything, so every variant is timed run to the budget (the same work
whatever the bits), and those that compute the kernel's bits also with early
termination (their results checked equal).  The variants are written to and
built in ``build/ldpc_3gpp_tpu_torch/probe/`` with the package's nvcc flags,
one ``nvcc`` each, all started together (a variant that does not build is
reported, not fatal), and launched through ``decode``'s internal ``_lib``.

    python3 -m ldpc_3gpp_tpu_torch.tools.layered_probe [min-sum] [sum-product] [batch ...]

prints one JSON line per family and batch (default: both families, each at
its own batches) with the card's name and power limit, each variant's
registers, stack and spills (``ptxas -v``), its blocks per SM (the CUDA
runtime's occupancy at the launch) and its times (means of several launches
each, CUDA events).  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import kernels_build
from ..ops import decoder_cuda
from ..ops.decoder_fast import _row_plan
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
_NO_STORE = (SOURCE,
             "  store_row_msgs<MSG>(w, Z, m1s, m2s, signs | (idx << MSG_IDX_SHIFT));\n", "", 1)
_ROW_CALL = ("        bad |= min_sum_row<MSG, OFFSET>(smem, edges + e0, deg, old, words + w, Z, "
             "z, z4,\n                                        Z4, alpha_t, a.beta);\n      }\n")
_NO_BARRIER = (SOURCE, _ROW_CALL + "      __syncthreads();\n", _ROW_CALL, 1)
_GROUP_BARRIERS = (
    SOURCE, _ROW_CALL + "      __syncthreads();\n",
    _ROW_CALL + "      if (__ldg(&edges_g[row_start[r + 1] - 1].w)) __syncthreads();\n", 1)
_NO_OLD_REBUILD = (
    (SOURCE, "  const unsigned old_idx = old.meta >> MSG_IDX_SHIFT;\n",
     "  asm volatile(\"\" ::\"r\"(old.m2s), \"r\"(old.meta));\n", 1),
    (SOURCE, "      const unsigned old_msg = (i == old_idx ? old.m2s : old.m1s) ^\n"
             "                               ((old.meta << (31 - i)) & SIGN_BIT);\n",
     "      const unsigned old_msg = old.m1s;\n", 1),
)
# every edge at its check lane: 4 * (col*Z + z), inside the edge's column
_NO_ROTATION = (
    (SOURCE, "      const int o = ed.z + z4 - (z >= ed.w ? Z4 : 0);\n",
     "      const int o = 4 * ed.x + z4;\n", 1),
    (SOURCE, "        total = reinterpret_cast<float*>(totals + ed.z + z4 - "
             "(z >= ed.w ? Z4 : 0));\n",
     "        total = reinterpret_cast<float*>(totals + 4 * ed.x + z4);\n", 1),
)
# the two smallest magnitudes of a row of more than 8 edges by a pairwise
# tree over its slots (predicated slots are 0xffffffff leaves, above every
# magnitude); ties go to the lower edge, as in the running tournament
_TREE = """// Two smallest of mg[LO, HI) and the first index of the smallest.
template <int LO, int HI, int N>
__device__ __forceinline__ void two_smallest(const unsigned (&mg)[N], unsigned& m1,
                                             unsigned& m2, unsigned& idx) {
  if constexpr (HI - LO == 1) {
    m1 = mg[LO];
    m2 = MAG_INF;
    idx = LO;
  } else {
    constexpr int MID = (LO + HI) / 2;
    unsigned a1, a2, ai, b1, b2, bi;
    two_smallest<LO, MID, N>(mg, a1, a2, ai);
    two_smallest<MID, HI, N>(mg, b1, b2, bi);
    idx = b1 < a1 ? bi : ai;
    m2 = min(max(a1, b1), min(a2, b2));
    m1 = min(a1, b1);
  }
}

"""
_LINEAR_VS_TREE = (
    (SOURCE, "template <typename MSG, int SLOTS, bool OFFSET>\n"
             "__device__ __forceinline__ unsigned min_sum_row_slots(",
     _TREE + "template <typename MSG, int SLOTS, bool OFFSET>\n"
     "__device__ __forceinline__ unsigned min_sum_row_slots(", 1),
    (SOURCE, "  int off[KEEP ? SLOTS : 1];\n",
     "  int off[KEEP ? SLOTS : 1];\n  unsigned mgs[SLOTS];\n#pragma unroll\n"
     "  for (int i = 0; i < SLOTS; ++i) mgs[i] = 0xffffffffu;\n", 1),
    (SOURCE, "      if (i == 0) {\n        m1 = mg;\n      } else {\n"
             "        idx = mg < m1 ? i : idx;",
     "      if constexpr (SLOTS > 8) {\n        mgs[i] = mg;\n      } else if (i == 0) {\n"
     "        m1 = mg;\n      } else {\n        idx = mg < m1 ? i : idx;", 1),
    (SOURCE, "  float m1f, m2f;\n  if constexpr (OFFSET) {",
     "  if constexpr (SLOTS > 8) two_smallest<0, SLOTS, SLOTS>(mgs, m1, m2, idx);\n"
     "  float m1f, m2f;\n  if constexpr (OFFSET) {", 1),
)
# more dynamic shared memory than half an SM's 233,472 bytes: one block per SM
_ONE_BLOCK_PER_SM = (
    (SOURCE, "  const int smem_bytes = ldpc_layered_shared_bytes(a.Z, a.nc, a.nr, a.E, P);\n",
     "  const int smem_bytes = max(ldpc_layered_shared_bytes(a.Z, a.nc, a.nr, a.E, P), "
     "120 * 1024);\n",
     1),
    (SOURCE, "  const int smem_bytes = ldpc_layered_shared_bytes(Z, nc, nr, E, P);\n",
     "  const int smem_bytes = max(ldpc_layered_shared_bytes(Z, nc, nr, E, P), 120 * 1024);\n", 1),
)
# the min-sum kernel's totals on 26 columns (column c at c mod 26) and a
# budget of three blocks per SM
FOLDED_COLUMNS = 26
_THREE_BLOCKS = (
    (SOURCE, "__launch_bounds__(MAX_THREADS, 2)\nldpc_layered_min_sum_kernel(",
     "__launch_bounds__(MAX_THREADS, 3)\nldpc_layered_min_sum_kernel(", 1),
    (SOURCE, "    ed.z = 4 * (ed.x + ed.y);\n",
     f"    ed.x %= {FOLDED_COLUMNS} * Z;\n    ed.z = 4 * (ed.x + ed.y);\n", 1),
    (SOURCE, "  const int z4 = 4 * z, Z4 = 4 * Z;\n",
     "  const int z4 = 4 * z, Z4 = 4 * Z;\n"
     f"  edges = reinterpret_cast<int4*>(smem + align16((size_t){FOLDED_COLUMNS} * Z * 4));\n"
     "  row_start = reinterpret_cast<int*>(edges + E);\n", 1),
    (SOURCE, "  if (active)\n"
             "    load_totals(totals, llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z), z, a);\n"
             "  __syncthreads();\n\n  // this thread's lane of the codeword's words.",
     f"  DecodeArgs folded = a;\n  folded.nc = {FOLDED_COLUMNS};\n  if (active)\n"
     "    load_totals(totals, llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z), z, folded);\n"
     "  __syncthreads();\n\n  // this thread's lane of the codeword's words.", 1),
    (SOURCE, "  const int smem_bytes = ldpc_layered_shared_bytes(a.Z, a.nc, a.nr, a.E, P);\n",
     f"  const int smem_bytes = ldpc_layered_shared_bytes(a.Z, P > 1 || SUM_PRODUCT ? a.nc : "
     f"{FOLDED_COLUMNS}, a.nr, a.E, P);\n", 1),
    (SOURCE, "  const int smem_bytes = ldpc_layered_shared_bytes(Z, nc, nr, E, P);\n",
     f"  const int smem_bytes = ldpc_layered_shared_bytes(Z, P > 1 || rule == RULE_SUM_PRODUCT ? "
     f"nc : {FOLDED_COLUMNS}, nr, E, P);\n", 1),
)
# every row's words loaded, in sweep 0 too, their values then replaced by
# zeros there: no branch, more loads
_UNCONDITIONAL_LOADS = (
    SOURCE, "    if (!first || wrap)\n      q[LOOKAHEAD - 1] = load_row_msgs<MSG>(words + rn * "
            "(RowWords<MSG>::N * L), L);\n    return cur;\n",
    "    q[LOOKAHEAD - 1] = load_row_msgs<MSG>(words + rn * (RowWords<MSG>::N * L), L);\n"
    "    return first ? RowMsgs{0u, 0u, 0u} : cur;\n", 1)
# the words' loads and stores with an L2 eviction policy (half of the lines
# kept last) or through the L2 only (ld.global.cg, st.global.cg)
_L2_POLICY = """__device__ __forceinline__ unsigned long long words_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 0.5;" : "=l"(p));
  return p;
}
__device__ __forceinline__ unsigned ld_hint(const unsigned* a) {
  unsigned v;
  asm volatile("ld.global.L2::cache_hint.u32 %0, [%1], %2;"
               : "=r"(v) : "l"(a), "l"(words_policy()));
  return v;
}
__device__ __forceinline__ void st_hint(unsigned* a, unsigned v) {
  asm volatile("st.global.L2::cache_hint.u32 [%0], %1, %2;" :: "l"(a), "r"(v), "l"(words_policy())
               : "memory");
}

"""
_LOAD_F32 = "    m.m1s = w[0];\n    m.m2s = w[L];\n    m.meta = w[2 * L];\n"
_STORE_F32 = "    w[0] = m1s;\n    w[L] = m2s;\n    w[2 * L] = meta;\n"
_WORDS_L2_EVICT_LAST = (
    (HEADER, "template <typename MSG>\n__device__ __forceinline__ RowMsgs load_row_msgs(",
     _L2_POLICY + "template <typename MSG>\n__device__ __forceinline__ RowMsgs load_row_msgs(", 1),
    (HEADER, _LOAD_F32,
     "    m.m1s = ld_hint(w);\n    m.m2s = ld_hint(w + L);\n    m.meta = ld_hint(w + 2 * L);\n", 1),
    (HEADER, _STORE_F32,
     "    st_hint(w, m1s);\n    st_hint(w + L, m2s);\n    st_hint(w + 2 * L, meta);\n", 1),
)
_WORDS_CG = (
    (HEADER, _LOAD_F32,
     "    m.m1s = __ldcg(w);\n    m.m2s = __ldcg(w + L);\n    m.meta = __ldcg(w + 2 * L);\n", 1),
    (HEADER, _STORE_F32,
     "    __stcg(w, m1s);\n    __stcg(w + L, m2s);\n    __stcg(w + 2 * L, meta);\n", 1),
)
VARIANTS = {
    "kernel": (),
    "lookahead_2": (_LOOKAHEAD_2,),
    "no_scratch": (_NO_LOAD, _NO_STORE),
    "no_row_barrier": (_NO_BARRIER,),
    "no_scratch_no_barrier": (_NO_LOAD, _NO_STORE, _NO_BARRIER),
    "group_barriers": (_GROUP_BARRIERS,),
    "no_old_rebuild": _NO_OLD_REBUILD,
    "no_rotation": _NO_ROTATION,
    "linear_vs_tree": _LINEAR_VS_TREE,
    "one_block_per_sm": _ONE_BLOCK_PER_SM,
    "three_blocks": _THREE_BLOCKS,
    "addresses_kept_all": ((SOURCE, "constexpr int KEPT_SLOTS = 10;",
                            "constexpr int KEPT_SLOTS = 20;", 1),),
    "rows_19_at_max_deg": ((SOURCE, "    MIN_SUM_ROW_EXACT(19)\n", "", 1),),
    "no_opaque_asm": ((SOURCE, '  asm("" : "+l"(words));\n', "", 1),
                      (SOURCE, '    asm("" : "+f"(alpha_t));\n', "", 1)),
    "rule_branch": ((SOURCE, "  float m1f, m2f;\n  if constexpr (OFFSET) {",
                     "  float m1f, m2f;\n  if (OFFSET || alpha_t < 0.0f) {", 1),),
    "unconditional_loads": (_UNCONDITIONAL_LOADS,),
    "words_l2_evict_last": _WORDS_L2_EVICT_LAST,
    "words_cg": _WORDS_CG,
}
EXACT = ("kernel", "lookahead_2", "group_barriers", "linear_vs_tree", "one_block_per_sm",
         "addresses_kept_all", "rows_19_at_max_deg", "no_opaque_asm", "rule_branch",
         "unconditional_loads", "words_l2_evict_last", "words_cg")
FLAGSHIP = dict(BG=1, A=8424, G=25272, Q_m=2)
DECODE_KW = dict(iterations=12, algorithm="min-sum", alpha=0.8125, channel_format="d",
                 output_format="sys")
# codewords per launch: a sweep's call and a step of the flagship cell; and
# the launches per mean and the means per variant, by batch
BATCHES = (1024, 32768)
REPS = {1024: (10, 5), 32768: (2, 3)}

# The sum-product instantiation (V2) at P3's shape: its rows at MAX_DEG
# predicated slots (the row before the degree dispatch), its message round
# trip and its row barrier taken out.
_SP_MAX_DEG = (HEADER, "  switch (deg) {\n    SP_ROW_EXACT(3)",
               "  switch (0) {\n    SP_ROW_EXACT(3)", 1)
_SP_NO_LOAD = (HEADER, "      const float ve = first ? t : __fsub_rn(t, c2v[ed.z]);\n",
               "      const float ve = t;\n", 1)
_SP_NO_STORE = (HEADER, "      c2v[ed.z] = msg;\n", "", 1)
_SP_NO_BARRIER = (
    SOURCE, "      if (active) bad |= layered_sp_row(totals, c2v, edges, e0, deg, z, Z, first);\n"
            "      __syncthreads();\n",
    "      if (active) bad |= layered_sp_row(totals, c2v, edges, e0, deg, z, Z, first);\n", 1)
SP_VARIANTS = {
    "kernel": (),
    "max_deg_slots": (_SP_MAX_DEG,),
    "no_scratch": (_SP_NO_LOAD, _SP_NO_STORE),
    "no_row_barrier": (_SP_NO_BARRIER,),
    "no_scratch_no_barrier": (_SP_NO_LOAD, _SP_NO_STORE, _SP_NO_BARRIER),
}
P3 = dict(BG=2, A=2048, G=6144, Q_m=2)
SP_DECODE_KW = dict(iterations=8, algorithm="sum-product", channel_format="d",
                    output_format="sys")
# family -> (variants, code, Es/N0, decode arguments, kernel instantiation in
# ptxas's names, the variants that compute the kernel's bits, batches,
# repetitions by batch)
FAMILIES = {
    "min-sum": (VARIANTS, FLAGSHIP, 1.0, DECODE_KW, "_Z27ldpc_layered_min_sum_kernelIfLb0EE", EXACT,
                BATCHES, REPS),
    "sum-product": (SP_VARIANTS, P3, 2.0, SP_DECODE_KW, "_Z22ldpc_layered_sp_kernel",
                    ("kernel", "max_deg_slots"), (1024,), {1024: (10, 5)}),
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


def _blocks_per_sm(lib, params, kw) -> int:
    """Blocks of the variant's one-codeword launch that one SM holds."""
    return lib.ldpc_layered_blocks_per_sm(
        decoder_cuda._RULE_CODES[kw["algorithm"]], 0, 1, params.Z_c, params.num_cols,
        params.num_rows, len(params.edges[0]))


@functools.lru_cache(maxsize=None)
def row_groups(params: LDPCParams, row_seq) -> tuple:
    """Sizes of the groups of consecutive rows of ``row_seq`` in which no
    two rows share a column: a row joins the group before it unless it
    shares a column with a row of that group.  A group's rows touch disjoint
    columns, so they may update the totals without a barrier between them
    (BG1 in the reversed order: 32 groups of 46 rows; BG2: 28 of 42)."""
    by_row, _ = _row_plan(params)
    sizes, cols = [], set()
    for r in row_seq:
        mine = {c for (_, c, _) in by_row[r]}
        if not sizes or cols & mine:
            sizes.append(0)
            cols = set()
        sizes[-1] += 1
        cols |= mine
    return tuple(sizes)


@contextlib.contextmanager
def _group_barrier_plan():
    """``decode``'s device plans with the barrier flag of ``group_barriers``
    in the ``w`` word of each row's last edge: 1 where the next row shares a
    column with a row since the last barrier, and after the sweep's last
    row (``row_groups``)."""
    plain = decoder_cuda._graph_device

    @functools.lru_cache(maxsize=None)
    def plans(params, row_seq, device):
        edges, row_start, _ = decoder_cuda._graph_plan(params, row_seq)
        edges = edges.copy()
        ends = np.cumsum(row_groups(params, row_seq))
        edges[row_start[1:] - 1, 3] = 0
        edges[row_start[ends] - 1, 3] = 1
        return (torch.from_numpy(edges).to(device), torch.from_numpy(row_start).to(device))

    decoder_cuda._graph_device = plans
    try:
        yield
    finally:
        decoder_cuda._graph_device = plain


def probe(device, family: str = "min-sum", batches=None) -> dict:
    """{batch: record}: each variant's ptxas record, blocks per SM and times
    at the family's shape, run to the budget for all, with early termination
    for those that compute the kernel's bits (and whose results are checked
    equal)."""
    _, fields, esn0_db, kw, _, exact, default_batches, reps_by_n = FAMILIES[family]
    libs = build_variants(family)
    params = LDPCParams(**fields)
    budget = dict(kw, early_termination=False)
    out = {}
    for n in tuple(batches or default_batches):
        d = noisy_llrs(params, n, esn0_db, 21, device)
        reps, means = reps_by_n.get(n, (2, 3))
        rows, reference = {}, None
        for v, (lib, ptxas) in libs.items():
            if lib is None:
                rows[v] = ptxas
                continue
            plan = _group_barrier_plan() if v == "group_barriers" else contextlib.nullcontext()
            with plan:
                def times(kw):
                    return [time_ms(lambda: decoder_cuda.decode(params, d, _lib=lib, **kw), reps)
                            for _ in range(means)]

                rec = dict(ptxas, blocks_per_sm=_blocks_per_sm(lib, params, kw),
                           budget_ms=times(budget), budget=kw["iterations"])
                if v in exact:
                    res = decoder_cuda.decode(params, d, _lib=lib, **kw)
                    torch.cuda.synchronize()
                    got = (res.bits, res.parity_ok, res.iterations)
                    if reference is None:
                        reference = got
                    elif not all(torch.equal(a, b) for a, b in zip(got, reference)):
                        raise AssertionError(f"{v} differs from the kernel")
                    rec["early_termination_ms"] = times(kw)
                    rec["mean_iterations"] = float(res.iterations.float().mean())
            rows[v] = rec
        out[n] = dict(codewords=n, variants=rows)
        del d
    return out


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    families = [a for a in args if a in FAMILIES] or list(FAMILIES)
    batches = tuple(int(a) for a in args if a not in FAMILIES)
    if not torch.cuda.is_available():
        print("layered_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name_and_power_limit()
    for family in families:
        _, fields, esn0_db, kw = FAMILIES[family][:4]
        for rec in probe(dev, family, batches).values():
            print(json.dumps({"card": card, "family": family,
                              "shape": dict(fields, esn0_db=esn0_db, **kw), **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
