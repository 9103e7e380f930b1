"""What holds the layered kernels back, by taking their parts away.

``ncu`` cannot profile on the machine with the card, so this tool measures
the split that its stall reasons would give by building variants of
``csrc/ldpc_layered.cu`` that leave one part of the work out, or do it
another way, and timing each, 'd' in, 'sys' out.  Four families:

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
  ``no_scratch_no_barrier`` as above;

- ``packed`` (V7-layered, ``ldpc_layered_warp_kernel``) at config #1's code
  (BG2 A=100 Z=20, 2.0 dB, 12 sweeps; P = 2, 4, 16) and BG2 A=32 Z=8 (P = 4,
  8, 16), each beside the one-codeword kernel (P=1) at the same launch, at
  2,048 and 65,536 codewords: ``kernel``; ``no_scratch`` (no word loaded or
  stored); ``no_row_barrier`` (no ``__syncwarp`` between rows);
  ``no_stragglers`` (a warp's codewords stop when its first one passes);
  ``one_round`` (not persistent: a block for every P codewords, each warp
  its own, exact); ``jump_table`` (the one-codeword kernel's dispatch of a
  row by its degree, exact);

- ``packed_block``: the same launches in ``ldpc_layered_packed_kernel``
  (every min-sum launch of P > 1 sent there, as before the warp form):
  ``kernel``, ``no_scratch``, ``no_row_barrier``, ``no_stragglers`` (every
  codeword of a block stops at the block's first pass), ``warp_aligned``
  (codewords padded to whole warps, 32 / Z a warp, the row barrier a
  ``__syncwarp``, exact), ``words_on_chip`` (the words in shared memory,
  exact) and ``v1_row`` (``min_sum_row`` in place of the generic row,
  exact).

The variants that are not exact compute wrong bits; only their times mean
anything, so every variant is timed run to the budget (the same work
whatever the bits), and those that compute the kernel's bits also with early
termination (their results checked equal).  The variants are written to and
built in ``build/ldpc_3gpp_tpu_torch/probe/`` with the package's nvcc flags,
one ``nvcc`` each, all started together (a variant that does not build is
reported, not fatal), and launched through ``decode``'s internal ``_lib``.

    python3 -m ldpc_3gpp_tpu_torch.tools.layered_probe [min-sum] [sum-product] [packed]
        [packed_block] [batch ...]

prints one JSON line per family and batch (default: every family, each at
its own batches) with the card's name and power limit, each variant's
registers, stack and spills (``ptxas -v``), its blocks per SM (the CUDA
runtime's occupancy at the launch) and its times (means of several launches
each, CUDA events).  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import inspect
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
    (SOURCE, "  const int smem_bytes = ldpc_layered_shared_bytes(rule, bf16, a.Z, a.nc, a.nr, "
             "a.E, P);\n",
     "  const int smem_bytes = max(ldpc_layered_shared_bytes(rule, bf16, a.Z, a.nc, a.nr, a.E, "
     "P), 120 * 1024);\n", 1),
    (SOURCE, "  const int smem_bytes = ldpc_layered_shared_bytes(rule, bf16, Z, nc, nr, E, P);\n",
     "  const int smem_bytes = max(ldpc_layered_shared_bytes(rule, bf16, Z, nc, nr, E, P), "
     "120 * 1024);\n", 1),
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
    (SOURCE, "  const int smem_bytes = ldpc_layered_shared_bytes(rule, bf16, a.Z, a.nc, a.nr, "
             "a.E, P);\n",
     f"  const int smem_bytes = ldpc_layered_shared_bytes(rule, bf16, a.Z, P > 1 || SUM_PRODUCT ? "
     f"a.nc : {FOLDED_COLUMNS}, a.nr, a.E, P);\n", 1),
    (SOURCE, "  const int smem_bytes = ldpc_layered_shared_bytes(rule, bf16, Z, nc, nr, E, P);\n",
     f"  const int smem_bytes = ldpc_layered_shared_bytes(rule, bf16, Z, P > 1 || rule == "
     f"RULE_SUM_PRODUCT ? nc : {FOLDED_COLUMNS}, nr, E, P);\n", 1),
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
# The packed kernel (V7-layered, ``ldpc_layered_packed_kernel``) at config
# #1's code (BG2 A=100 Z=20, 2.0 dB, 12 sweeps) with P = 2 and 4, and at
# Z=8 (BG2 A=32 G=64, 2.0 dB) with P = 4 and 8; each beside the
# one-codeword kernel (P=1) at the same launch.
_PK_NO_LOAD = (SOURCE, "          const RowMsgs old = ahead.next(words, r, nr, L, first);\n",
               "          const RowMsgs old = RowMsgs{0u, 0u, 0u};\n", 1)
_PK_NO_STORE = (HEADER,
                "  store_row_msgs<MSG>(w, L, m1s, m2s, signs | (idx << MSG_IDX_SHIFT));\n", "", 1)
_PK_ROW_END = ("              e0, deg, z, Z, first, alpha_t, a.offset_rule, a.beta);\n"
               "        }\n      }\n")
_PK_NO_BARRIER = (SOURCE, _PK_ROW_END + "      __syncthreads();\n", _PK_ROW_END, 1)
# codewords padded to whole warps, 32 / Z of them a warp (Z <= 32), and the
# row barrier a __syncwarp: exact, since no codeword straddles a warp
_PK_WARP_ALIGNED = (
    (SOURCE, "  const int k = t / Z;       // codeword of this thread within the block\n"
             "  const int z = t - k * Z;   // its lane\n",
     "  const int G = Z <= 32 ? 32 / Z : 1;  // codewords per warp\n"
     "  const int k = (t >> 5) * G + (t & 31) / Z;\n"
     "  const int z = (t & 31) - ((t & 31) / Z) * Z;\n", 1),
    (SOURCE, "  const bool active = k < P && cw < (size_t)ncw;\n",
     "  const bool active = (t & 31) / Z < G && k < P && cw < (size_t)ncw;\n", 1),
    (SOURCE, "((size_t)E * L) + t;\n", "((size_t)E * L) + k * Z + z;\n", 1),
    (SOURCE, "((size_t)nr * RowWords<MSG>::N * L) + t;\n",
     "((size_t)nr * RowWords<MSG>::N * L) + k * Z + z;\n", 1),
    (SOURCE, _PK_ROW_END + "      __syncthreads();\n", _PK_ROW_END + "      __syncwarp();\n", 1),
    (SOURCE, "warp_count(Z, P) * 32 : (P * Z + 31) / 32 * 32;\n",
     "warp_count(Z, P) * 32\n"
     "      : (P > 1 && Z <= 32 ? (P + 32 / Z - 1) / (32 / Z) * 32 : (P * Z + 31) / 32 * 32);\n",
     1),
)
# the P codewords' words in shared memory after the flag words, not in the
# scratch (exact)
_PK_WORDS_ON_CHIP = (
    (SOURCE, "  unsigned* words = static_cast<unsigned*>(scratch) +\n"
             "                    (size_t)blockIdx.x * ((size_t)nr * RowWords<MSG>::N * L) + t;\n",
     "  unsigned* words = reinterpret_cast<unsigned*>(flags + P) + t;\n", 1),
    (SOURCE, "               (size_t)(nr + 1) * 4 + (P > 1 ? (size_t)P * 4 : 0));\n",
     "               (size_t)(nr + 1) * 4 + (P > 1 ? (size_t)P * 4 : 0) +\n"
     "               (P > 1 && rule != RULE_SUM_PRODUCT ? (size_t)nr * (bf16_messages ? 2 : 3) * "
     "P * Z * 4 : 0));\n", 1),
)
# the row of the one-codeword min-sum kernel (min_sum_row: byte offsets and
# wrap lanes in the edge records, no `first` select, the rule normalized
# min-sum at compile time) in place of layered_row_compressed
_PK_V1_ROW = (
    (SOURCE, "    int4 ed = edges_g[i];\n    ed.z *= P;\n    edges[i] = ed;\n",
     "    int4 ed = edges_g[i];\n    if constexpr (SUM_PRODUCT) {\n      ed.z *= P;\n"
     "    } else {\n      ed.z = 4 * (ed.x + ed.y);\n      ed.w = Z - ed.y;\n    }\n"
     "    edges[i] = ed;\n", 1),
    (SOURCE, "          bad |= layered_row_compressed<MSG>(\n"
             "              totals, old, words + (size_t)r * RowWords<MSG>::N * L, L, edges,\n"
             "              e0, deg, z, Z, first, alpha_t, a.offset_rule, a.beta);\n",
     "          bad |= min_sum_row<MSG, false>(\n"
     "              reinterpret_cast<unsigned char*>(totals), edges + e0, deg, old,\n"
     "              words + (size_t)r * RowWords<MSG>::N * L, L, z, 4 * z, 4 * Z, alpha_t,\n"
     "              a.beta);\n", 1),
)
# every codeword of a block stops when the first one passes (not exact)
_PK_NO_STRAGGLERS = (SOURCE, "      if (__syncthreads_and(done)) break;\n",
                     "      if (__syncthreads_or(done)) break;\n", 1)
# every min-sum launch of P > 1 in the packed kernel, as before the warp form
_PK_BLOCK_FORM = (
    (SOURCE, "  return rule != RULE_SUM_PRODUCT && P > 1 && Z <= 32;\n", "  return false;\n", 1),
)
BLOCK_VARIANTS = {
    "kernel": _PK_BLOCK_FORM,
    "no_scratch": _PK_BLOCK_FORM + (_PK_NO_LOAD, _PK_NO_STORE),
    "no_row_barrier": _PK_BLOCK_FORM + (_PK_NO_BARRIER,),
    "warp_aligned": _PK_BLOCK_FORM + _PK_WARP_ALIGNED,
    "words_on_chip": _PK_BLOCK_FORM + _PK_WORDS_ON_CHIP,
    "v1_row": _PK_BLOCK_FORM + _PK_V1_ROW,
    "no_stragglers": _PK_BLOCK_FORM + (_PK_NO_STRAGGLERS,),
}
# The warp kernel (``ldpc_layered_warp_kernel``) at the same launches.
_WK_ROW = ("          bad |= warp_row<MSG, OFFSET>(totals, edges + cur.x, cur.y, cur_old, "
           "words + w, L, z,\n                                       z4, Z4, alpha_t, a.beta);\n")
_WK_ONE_ROUND = (
    (SOURCE, "    if (lane == 0) first_cw = atomicAdd(next, taken);\n",
     "    if (lane == 0) first_cw = (blockIdx.x * (blockDim.x >> 5) + warp) * G;\n", 1),
    (SOURCE, "    __syncwarp();  // every lane's reads of this state before the next codeword's "
             "loads\n  }\n",
     "    break;\n  }\n", 1),
    (SOURCE, "  return min((ncw + P - 1) / P, max(1, sms * per_sm));\n",
     "  return (ncw + P - 1) / P;\n", 1),
)
PACKED_VARIANTS = {
    "kernel": (),
    "no_scratch": ((SOURCE, "        old = load_row_msgs<MSG>(words + wn, L);\n",
                    "        old = RowMsgs{0u, 0u, 0u};\n", 1),
                   (SOURCE, "  store_row_msgs<MSG>(w, Z, m1s, m2s, signs | (idx << "
                            "MSG_IDX_SHIFT));\n", "", 1)),
    "no_row_barrier": ((SOURCE, _WK_ROW + "        __syncwarp();\n", _WK_ROW, 1),),
    # a warp's codewords stop when its first one passes (not exact)
    "no_stragglers": ((SOURCE, "        if (__all_sync(FULL_WARP, done)) break;\n",
                       "        if (__any_sync(FULL_WARP, passed)) break;\n", 1),),
    # not persistent: a block for every P codewords, each warp its own G (exact)
    "one_round": _WK_ONE_ROUND,
    # the rows dispatched by the one-codeword kernel's jump table on the
    # degree (min_sum_row), not a chain of tests (exact)
    "jump_table": ((SOURCE, "          bad |= warp_row<MSG, OFFSET>(",
                    "          bad |= min_sum_row<MSG, OFFSET>(", 1),),
}
CONFIG1 = dict(BG=2, A=100, G=200, Q_m=2)
Z8 = dict(BG=2, A=32, G=64, Q_m=2)
# (launch, code, codewords per block) at each batch; P=1 is the one-codeword
# kernel, which no packed variant changes
PACKED_LAUNCHES = (("z20_p1", CONFIG1, 1), ("z20_p2", CONFIG1, 2), ("z20_p4", CONFIG1, 4),
                   ("z20_p16", CONFIG1, 16), ("z8_p1", Z8, 1), ("z8_p4", Z8, 4),
                   ("z8_p8", Z8, 8), ("z8_p16", Z8, 16))
PACKED_BATCHES = (2048, 65536)
PACKED_REPS = {2048: (20, 3), 65536: (2, 3)}
# family -> (variants, code, Es/N0, decode arguments, kernel instantiation in
# ptxas's names, the variants that compute the kernel's bits, batches,
# repetitions by batch)
FAMILIES = {
    "min-sum": (VARIANTS, FLAGSHIP, 1.0, DECODE_KW, "_Z27ldpc_layered_min_sum_kernelIfLb0EE", EXACT,
                BATCHES, REPS),
    "sum-product": (SP_VARIANTS, P3, 2.0, SP_DECODE_KW, "_Z22ldpc_layered_sp_kernel",
                    ("kernel", "max_deg_slots"), (1024,), {1024: (10, 5)}),
    "packed": (PACKED_VARIANTS, CONFIG1, 2.0, DECODE_KW,
               "_Z24ldpc_layered_warp_kernelIfLb0EE", ("kernel", "one_round", "jump_table"),
               PACKED_BATCHES, PACKED_REPS),
    "packed_block": (BLOCK_VARIANTS, CONFIG1, 2.0, DECODE_KW,
                     "_Z26ldpc_layered_packed_kernelILb0EfE",
                     ("kernel", "warp_aligned", "words_on_chip", "v1_row"), PACKED_BATCHES,
                     PACKED_REPS),
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


def probe_packed(device, batches=None, family: str = "packed") -> dict:
    """{batch: record}: each variant's ptxas record and, per launch of
    PACKED_LAUNCHES, its blocks per SM and times run to the budget, with
    early termination for those that compute the kernel's bits (checked
    equal).  The one-codeword launches (P=1) run the kernel's build only."""
    variants, _, esn0_db, kw, _, exact, default_batches, reps_by_n = FAMILIES[family]
    libs = build_variants(family)
    budget = dict(kw, early_termination=False)
    out = {}
    for n in tuple(batches or default_batches):
        reps, means = reps_by_n.get(n, (2, 3))
        launches = {}
        for name, fields, P in PACKED_LAUNCHES:
            params = LDPCParams(**fields)
            d = noisy_llrs(params, n, esn0_db, 21, device)
            rows, reference = {}, None
            for v, (lib, ptxas) in libs.items():
                if P == 1 and v != "kernel":
                    continue
                if lib is None:
                    rows[v] = ptxas
                    continue

                def times(kw):
                    return [time_ms(lambda: decode_build(
                        lib, params, d, codewords_per_block=P, **kw), reps)
                        for _ in range(means)]

                rec = dict(ptxas, blocks_per_sm=lib.ldpc_layered_blocks_per_sm(
                    0, 0, P, params.Z_c, params.num_cols, params.num_rows,
                    len(params.edges[0])), budget_ms=times(budget), budget=kw["iterations"])
                if v in exact:
                    res = decode_build(lib, params, d, codewords_per_block=P, **kw)
                    torch.cuda.synchronize()
                    got = (res.bits, res.parity_ok, res.iterations)
                    if reference is None:
                        reference = got
                    elif not all(torch.equal(a, b) for a, b in zip(got, reference)):
                        raise AssertionError(f"{v} differs from the kernel at {name}")
                    rec["early_termination_ms"] = times(kw)
                    rec["mean_iterations"] = float(res.iterations.float().mean())
                rows[v] = rec
            launches[name] = dict(Z=params.Z_c, A=params.A, P=P, variants=rows)
            del d
        out[n] = dict(codewords=n, launches=launches)
    return out


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


def decode_build(lib, params: LDPCParams, llr: torch.Tensor, **kw) -> decoder_cuda.DecodeResult:
    """``decoder_cuda.decode`` of a layered launch (CUDA ``llr``, the same
    arguments) through ``lib``, a build of other sources that may size its
    blocks otherwise (a ``packed_block`` variant, another tree's kernel):
    every min-sum launch of P > 1 gets the packed kernel's message scratch,
    which also holds the warp form's codeword counter, and the library checks
    its own block."""
    a = inspect.signature(decoder_cuda.decode).bind(params, llr, **kw)
    a.apply_defaults()
    a = a.arguments
    algorithm, message_dtype = a["algorithm"], a["message_dtype"]
    dtype, nci, out_cols, alpha_schedule = decoder_cuda._check_arguments(
        params, llr, algorithm, "layered", message_dtype, a["channel_format"],
        a["output_format"], a["alpha_schedule"])
    Z, nc, nr, E = params.Z_c, params.num_cols, params.num_rows, len(params.edges[0])
    dev = llr.device
    flat = llr.to(torch.float32).reshape(-1, nci * Z).contiguous()
    n = flat.shape[0]
    P = decoder_cuda.resolve_codewords_per_block(
        params, n, "layered", a["codewords_per_block"], algorithm, message_dtype,
        decoder_cuda._sm_count(dev))
    if P > 1 and algorithm != "sum-product":
        shape = ((-(-n // P), nr, decoder_cuda.COMPRESSED_WORDS[dtype], P * Z), torch.int32)
    else:
        shape = decoder_cuda.scratch_shape(params, n, "layered", algorithm, message_dtype, P)
    scratch = torch.empty(shape[0], dtype=shape[1], device=dev)
    plans = decoder_cuda._graph_device(
        params, decoder_cuda._resolve_layer_order(params, a["layer_order"]), dev)
    bits = torch.empty((n, out_cols * Z), dtype=torch.int8, device=dev)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    iters = torch.empty((n,), dtype=torch.int32, device=dev)
    lo, hi = params.filler_range_d if a["channel_format"] == "d" else (0, 0)
    a0, n0 = alpha_schedule if alpha_schedule is not None else (a["alpha"], 0)
    with torch.cuda.device(dev):
        err = lib.ldpc_layered_decode(
            flat.data_ptr(), bits.data_ptr(), ok.data_ptr(), iters.data_ptr(),
            scratch.data_ptr(), *(t.data_ptr() for t in plans), n, Z, nc, nr, E, out_cols,
            int(a["channel_format"] == "d"), lo, hi, int(a["iterations"]),
            int(bool(a["early_termination"])), decoder_cuda._RULE_CODES[algorithm],
            int(dtype == torch.bfloat16), P, float(a["alpha"]), float(a["beta"]), float(a0),
            int(n0), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ldpc_layered kernel launch failed: CUDA error {err}")
    return decoder_cuda.DecodeResult(bits=bits, parity_ok=ok.to(torch.bool), iterations=iters)


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
        run = (probe_packed(dev, batches, family) if family.startswith("packed")
               else probe(dev, family, batches))
        for rec in run.values():
            print(json.dumps({"card": card, "family": family,
                              "shape": dict(fields, esn0_db=esn0_db, **kw), **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
