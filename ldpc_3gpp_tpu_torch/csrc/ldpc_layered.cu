// Layered belief-propagation LDPC decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ldpc_3gpp_tpu/ops/decoder_pallas.py::_make_kernel in
// its layered configurations: min-sum / offset-min-sum / sum-product, f32
// messages or (min-sum family) bfloat16 messages, early termination or
// run-to-budget, 'd' or 'cw' input, 'sys' or 'cw' output, any row order,
// optional alpha schedule.  The plain PyTorch version of the same arithmetic
// is ops/decoder_layered.py; results are bit-identical.
//
// What bounds it on this card.  Per codeword and sweep the algorithm touches
// every edge of the lifted graph once: 2*E*Z shared-memory accesses of the
// posterior totals (one rotated read, one write back) and the check-to-
// variable messages of every row, read and written once.  The totals
// (nc*Z*4 B = 102 KiB at BG1 Z=384) fit a block's shared memory; the
// messages do not, so they live in a global scratch tensor and their traffic
// goes through L2 to device memory.  A row cannot start before the previous
// row's totals are written (one barrier per row), and shared memory holds
// two blocks of one codeword each per SM.  Taken apart on an H100 at the
// flagship's launch (tools/layered_probe.py, PERF.md section 6), the min-sum
// family is bound by the instructions it issues per edge and lane and by
// their latency: the old messages' rebuild and the rotation are a tenth of
// the time each, the words' traffic a quarter, the row barriers 1 %.
// Sum-product evaluates phi twice per edge and lane (about 60 operations
// each, one of them a division) and is bound by that arithmetic.
//
// What the design does about it.  One block decodes one codeword; thread z
// owns check z of the current base row.  Totals stay in shared memory for
// the whole decode, in variable coordinates, so a circulant rotation is the
// address (z + shift) mod Z.  A row is unrolled to its own degree, so its
// instructions are those of its own edges (at the densest row's 20
// predicated slots a BG1 sweep would issue the work of 920 edges for its
// 316).  The min-sum family (ldpc_layered_min_sum_kernel, one instantiation
// per rule and message type) issues as few instructions per edge and per
// row as 80 registers allow: each edge record carries its byte offset at
// lane `shift` and its wrap lane, so an address is a compare, a select and
// an add; rows of up to ten edges keep their v_i and addresses in registers
// for the second pass, longer rows park v_i in the total's own place (kept
// in registers, the long rows spilled the whole row loop); sweep 0 needs no
// flag, since its words are zero; the words' pointer and the sweep's alpha
// stay in registers across rows.  It keeps a row's messages in compressed
// form (ldpc_bp.cuh): the two scaled smallest magnitudes with the row's
// sign, the sign bits and the index of the smallest, three 32-bit words per
// row and lane (two with bfloat16 messages), which rebuild every message of
// the row bit for bit.  That is 207 KiB per codeword at BG1 Z=384 instead of
// E*Z*4 B = 474 KiB per edge (138 KiB in bfloat16 instead of 237).  The
// scratch is laid out (row, word, Z) in processing order: each word is a
// lane-contiguous plane, so a warp's loads are 128-byte coalesced, and
// thread z alone reads and writes lane z of a row's words.  The words of
// the next row therefore depend on nothing that the row barrier protects: a
// thread loads them LOOKAHEAD rows before their use, and their latency hides
// behind the current row and its barrier.  Two blocks share an SM (shared
// memory holds no third at BG1 Z=384).  Tried on an H100 and left out
// (PERF.md section 6): two checks a thread (192 threads; it spilled and
// halved the warps), barriers only between rows that share a column (a flag
// and a branch a row cost more than the barriers saved), a pairwise tree for
// the long rows' two smallest magnitudes, L2 eviction priorities for the
// words, and loading every row's words unconditionally.  Sum-product
// (ldpc_layered_sp_kernel, thread z owns check z) has no compressed form and
// keeps one float per edge, laid out (E, Z).  Its row is unrolled to its
// own degree too (a row of MAX_DEG predicated slots issued the work of 20
// edges, two phi each, for rows of 3 to 10), and v_i waits between the
// row's two halves in the total's own place rather than in registers: 71
// registers, four 224-thread blocks per SM at BG2 Z=208, 1.50-1.52 ms
// against 1.92-1.94 for the MAX_DEG row on an H100 (P3's shape, 1,024
// codewords).  What bounds it now is the row's chain of two phi per edge
// and its message loads from device memory (the scratch of 1,024 codewords
// is three times the L2): without the message traffic the kernel takes a
// quarter less time (tools/layered_probe.py).  Staging the next row's
// messages in shared memory with cp.async saved another 3 % but took 80
// registers, three blocks per SM (capped at 72 it spilled), and was left
// out.  Sweep 0 never reads the messages (they are known to be zero), which
// also spares zero-filling the scratch.  A block stops at the sweep in which
// its codeword's parity passed, so early termination saves its full share
// of traffic.  Within a row every edge has its own column and within an
// edge every lane its own address, so a row needs no atomics: one barrier
// per row.
//
// The check-node update, phi and the notes on bit-exactness are in
// ldpc_bp.cuh, shared with the flooding kernel.
//
// Several small-Z codewords per block (ldpc_layered_packed_kernel below)
// replaces the TPU kernel's packed tiles (decoder_pallas.py::_auto_pack,
// the segment-local parity vote and the pack/unpack transposes of its
// wrapper).  What bounds a small-Z block on this card: one block per codeword
// is one warp with Z live lanes (20 of 32 at Z=20), a block-wide barrier per
// row for that one warp, a private copy of the edge table per block, and at
// most 32 resident blocks per SM, half of its 64 warps.  The packed kernel
// gives a block P codewords: thread t owns lane t % Z of codeword t / Z, one
// edge table serves all P, and the block's share of the scratch is laid out
// (row, word, P*Z) (sum-product: (E, P*Z)) so that a row's words are one
// contiguous run across the P codewords.  Votes and stops are per codeword
// (a flag word each in shared memory, set between two barriers); a codeword
// that passed stops at the sweep the one-codeword kernel stops at and writes
// nothing afterwards, its lanes still reach every barrier, and the block
// leaves when all P are done.
// It is a kernel of its own, so the one-codeword kernel keeps its registers.

#include "ldpc_bp.cuh"

// Rows by which a thread loads a row's message words ahead of their use.
// On an H100, 1 and 2 were within 1.1 % of each other, 1 ahead once rows ran
// at their own degree (PERF.md section 6; tools/layered_probe.py times 2).
constexpr int LOOKAHEAD = 1;

// The min-sum family's words of the rows ahead of the current one, in
// registers.  `next` returns row r's words and issues the load of row
// r + LOOKAHEAD, which past the last row is a row of the next sweep, written
// earlier in this one.  In sweep 0 only those rows are loaded: the others
// hold nothing yet, and sweep 0 reads no message.  A load that early
// termination then discards is harmless.
template <typename MSG>
struct RowsAhead {
  RowMsgs q[LOOKAHEAD] = {};

  __device__ __forceinline__ RowMsgs next(const unsigned* words, int r, int nr,
                                          int L, bool first) {
    const RowMsgs cur = q[0];
#pragma unroll
    for (int k = 0; k + 1 < LOOKAHEAD; ++k) q[k] = q[k + 1];
    int rn = r + LOOKAHEAD;
    const bool wrap = rn >= nr;
    if (wrap) rn -= nr;
    if (!first || wrap)
      q[LOOKAHEAD - 1] = load_row_msgs<MSG>(words + rn * (RowWords<MSG>::N * L), L);
    return cur;
  }
};

// One base row's layered min-sum / offset-min-sum update by the thread that
// owns check z: layered_row_slots (ldpc_bp.cuh) with fewer instructions per
// edge.  `ms` is the row's first edge in the kernel's edge table, whose .z
// is the byte offset in the totals of the edge's column at lane `shift`
// (4 * (col*Z + shift)) and .w the first lane that wraps (Z - shift), so
// that lane z's byte offset is .z + 4z - (z >= .w ? 4Z : 0).  No `first`
// flag: in sweep 0 the row's words are all zero (RowsAhead), so every old
// message is +0.0 and t - (+0.0) == t exactly.  A row of up to KEPT_SLOTS
// edges keeps its v_i and their offsets in registers for the second pass;
// a longer row (BG1's four rows of 19 edges) parks each v_i in its total's
// own place (thread z alone touches lane z of the row's columns until the
// row barrier) and reads its record again, so that the kernel's register
// budget is that of the short rows: with the long rows' v_i in registers
// the whole row loop spilled at 80 registers.
// The rule is a template parameter (OFFSET: offset-min-sum), so that a row
// issues one rule's arithmetic and no branch.  Returns the XOR of the sign
// bits of the totals read (the row's parity).
constexpr int KEPT_SLOTS = 10;

template <typename MSG, int SLOTS, bool OFFSET>
__device__ __forceinline__ unsigned min_sum_row_slots(
    unsigned char* totals, const int4* ms, int deg, const RowMsgs& old, unsigned* w,
    int Z, int z, int z4, int Z4, float alpha_t, float beta) {
  constexpr bool KEEP = SLOTS <= KEPT_SLOTS;
  float v[KEEP ? SLOTS : 1];
  int off[KEEP ? SLOTS : 1];
  unsigned par = 0, sx = 0, m1 = MAG_INF, m2 = MAG_INF, idx = 0, signs = 0;
  const unsigned old_idx = old.meta >> MSG_IDX_SHIFT;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (i < deg) {
      const int4 ed = ms[i];
      const int o = ed.z + z4 - (z >= ed.w ? Z4 : 0);
      float* total = reinterpret_cast<float*>(totals + o);
      const float t = *total;
      par ^= __float_as_uint(t);
      const unsigned old_msg = (i == old_idx ? old.m2s : old.m1s) ^
                               ((old.meta << (31 - i)) & SIGN_BIT);
      const float ve = __fsub_rn(t, __uint_as_float(old_msg));
      if constexpr (KEEP) {
        v[i] = ve;
        off[i] = o;
      } else {
        *total = ve;
      }
      const unsigned b = __float_as_uint(ve);
      const unsigned mg = b & MAG_MASK;
      sx ^= b;
      signs |= (b >> 31) << i;
      if (i == 0) {
        m1 = mg;
      } else {
        idx = mg < m1 ? i : idx;
        m2 = min(m2, max(m1, mg));
        m1 = min(m1, mg);
      }
    }
  }
  float m1f, m2f;
  if constexpr (OFFSET) {
    m1f = fmaxf(__fsub_rn(__uint_as_float(m1), beta), 0.0f);
    m2f = fmaxf(__fsub_rn(__uint_as_float(m2), beta), 0.0f);
  } else {
    m1f = __fmul_rn(alpha_t, __uint_as_float(m1));
    m2f = __fmul_rn(alpha_t, __uint_as_float(m2));
  }
  const unsigned ssign = sx & SIGN_BIT;
  const unsigned m1s = __float_as_uint(m1f) ^ ssign;
  const unsigned m2s = __float_as_uint(m2f) ^ ssign;
  store_row_msgs<MSG>(w, Z, m1s, m2s, signs | (idx << MSG_IDX_SHIFT));
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (i < deg) {
      float* total;
      float vi;
      if constexpr (KEEP) {
        total = reinterpret_cast<float*>(totals + off[i]);
        vi = v[i];
      } else {
        const int4 ed = ms[i];
        total = reinterpret_cast<float*>(totals + ed.z + z4 - (z >= ed.w ? Z4 : 0));
        vi = *total;
      }
      const unsigned b = __float_as_uint(vi);
      const float msg = __uint_as_float((i == idx ? m2s : m1s) ^ (b & SIGN_BIT));
      *total = __fadd_rn(vi, msg);
    }
  }
  return par;
}

// min_sum_row_slots unrolled to the row's own degree, 3 to 10 and 19 (BG1's
// four core rows; a row's degree is the same for every thread of the
// block); any other degree takes MAX_DEG predicated slots.
template <typename MSG, bool OFFSET>
__device__ __forceinline__ unsigned min_sum_row(
    unsigned char* totals, const int4* ms, int deg, const RowMsgs& old, unsigned* w,
    int Z, int z, int z4, int Z4, float alpha_t, float beta) {
#define MIN_SUM_ROW_EXACT(D)                                                               \
  case D:                                                                                 \
    return min_sum_row_slots<MSG, D, OFFSET>(totals, ms, D, old, w, Z, z, z4, Z4, alpha_t, \
                                             beta);
  switch (deg) {
    MIN_SUM_ROW_EXACT(3) MIN_SUM_ROW_EXACT(4) MIN_SUM_ROW_EXACT(5) MIN_SUM_ROW_EXACT(6)
    MIN_SUM_ROW_EXACT(7) MIN_SUM_ROW_EXACT(8) MIN_SUM_ROW_EXACT(9) MIN_SUM_ROW_EXACT(10)
    MIN_SUM_ROW_EXACT(19)
    default:
      return min_sum_row_slots<MSG, MAX_DEG, OFFSET>(totals, ms, deg, old, w, Z, z, z4, Z4,
                                                     alpha_t, beta);
  }
#undef MIN_SUM_ROW_EXACT
}

// The min-sum family, one codeword per block: thread z owns check z of the
// current row.  `words`: nr*N*Z words per codeword, laid out (row, word, Z)
// in processing order (RowWords<MSG>::N words per row and lane).  The edge
// table in shared memory keeps the plan's column offset and shift (.x, .y:
// the syndrome pass) and adds each edge's byte offset and wrap lane (.z,
// .w: min_sum_row_slots).  A row's words are found by a running offset.
// OFFSET selects offset-min-sum (a.offset_rule), else normalized min-sum.
template <typename MSG, bool OFFSET>
__global__ void __launch_bounds__(MAX_THREADS, 2)
ldpc_layered_min_sum_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                            int* __restrict__ ok_out, int* __restrict__ it_out,
                            unsigned* __restrict__ words_g,
                            const int4* __restrict__ edges_g,
                            const int* __restrict__ row_start_g, DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);
  int4* edges = reinterpret_cast<int4*>(smem + align16((size_t)nc * Z * 4));
  int* row_start = reinterpret_cast<int*>(edges + E);

  const int z = threadIdx.x;
  const bool active = z < Z;
  const int z4 = 4 * z, Z4 = 4 * Z;
  const size_t cw = blockIdx.x;

  for (int i = z; i < E; i += blockDim.x) {
    int4 ed = edges_g[i];
    ed.z = 4 * (ed.x + ed.y);
    ed.w = Z - ed.y;
    edges[i] = ed;
  }
  for (int i = z; i <= nr; i += blockDim.x) row_start[i] = row_start_g[i];

  // Channel LLRs into the totals, in variable coordinates.
  if (active)
    load_totals(totals, llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z), z, a);
  __syncthreads();

  // this thread's lane of the codeword's words.  The empty asm statements
  // make the pointer and the sweep's alpha opaque, so that the row loop
  // keeps them in registers: without them the compiler rebuilt the 64-bit
  // pointer from the block index, and reloaded alpha, in every row.
  unsigned* words = words_g + cw * (size_t)(nr * RowWords<MSG>::N * Z) + z;
  asm("" : "+l"(words));
  const int row_words = RowWords<MSG>::N * Z;
  RowsAhead<MSG> ahead;
  int used = a.iterations;
  bool done = false;

  for (int it = 0; it < a.iterations; ++it) {
    const bool first = it == 0; // all messages are zero: skip their read
    float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
    asm("" : "+f"(alpha_t));
    unsigned bad = 0;
    for (int r = 0, w = 0; r < nr; ++r, w += row_words) {
      const int e0 = row_start[r];
      const int deg = row_start[r + 1] - e0;
      // parity of the totals as read in this sweep
      if (active) {
        const RowMsgs old = ahead.next(words, r, nr, Z, first);
        bad |= min_sum_row<MSG, OFFSET>(smem, edges + e0, deg, old, words + w, Z, z, z4,
                                        Z4, alpha_t, a.beta);
      }
      __syncthreads();
    }
    if (a.early_termination) {
      const int any_bad = __syncthreads_or(active && (bad & SIGN_BIT));
      if (!any_bad) { // uniform over the block
        done = true;
        used = it;
        break;
      }
    }
  }

  // A codeword that never passed (or a run to budget) gets one clean
  // syndrome pass over the settled totals.
  int ok = 1;
  if (!done) {
    unsigned bad = 0;
    if (active) bad = syndrome_bits(totals, edges, row_start, nr, z, Z);
    ok = !__syncthreads_or(active && (bad & SIGN_BIT));
  }

  if (active) {
    int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
    for (int c = 0; c < a.out_cols; ++c)
      dst[c * Z + z] = totals[c * Z + z] < 0.0f;
  }
  if (z == 0) {
    ok_out[cw] = ok;
    it_out[cw] = used;
  }
}

// The layered sum-product kernel (V2), one codeword per block: thread z owns
// check z of the current row.  `c2v`: E*Z float messages per codeword, laid
// out (E, Z).  Sum-product keeps a row's inputs and their phi in registers
// and is not held to two blocks per SM.
__global__ void __launch_bounds__(MAX_THREADS, 1)
ldpc_layered_sp_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                       int* __restrict__ ok_out, int* __restrict__ it_out,
                       float* __restrict__ c2v_g,
                       const int4* __restrict__ edges_g,
                       const int* __restrict__ row_start_g, DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);
  int4* edges = reinterpret_cast<int4*>(smem + align16((size_t)nc * Z * 4));
  int* row_start = reinterpret_cast<int*>(edges + E);

  const int z = threadIdx.x;
  const bool active = z < Z;
  const size_t cw = blockIdx.x;

  for (int i = z; i < E; i += blockDim.x) edges[i] = edges_g[i];
  for (int i = z; i <= nr; i += blockDim.x) row_start[i] = row_start_g[i];

  // Channel LLRs into the totals, in variable coordinates.
  if (active)
    load_totals(totals, llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z), z, a);
  __syncthreads();

  // this thread's lane of the codeword's messages
  float* c2v = c2v_g + cw * (size_t)(E * Z) + z;
  int used = a.iterations;
  bool done = false;

  for (int it = 0; it < a.iterations; ++it) {
    const bool first = it == 0; // all messages are zero: skip their read
    unsigned bad = 0;
    for (int r = 0; r < nr; ++r) {
      const int e0 = row_start[r];
      const int deg = row_start[r + 1] - e0;
      // parity of the totals as read in this sweep
      if (active) bad |= layered_sp_row(totals, c2v, edges, e0, deg, z, Z, first);
      __syncthreads();
    }
    if (a.early_termination) {
      const int any_bad = __syncthreads_or(active && (bad & SIGN_BIT));
      if (!any_bad) { // uniform over the block
        done = true;
        used = it;
        break;
      }
    }
  }

  // A codeword that never passed (or a run to budget) gets one clean
  // syndrome pass over the settled totals.
  int ok = 1;
  if (!done) {
    unsigned bad = 0;
    if (active) bad = syndrome_bits(totals, edges, row_start, nr, z, Z);
    ok = !__syncthreads_or(active && (bad & SIGN_BIT));
  }

  if (active) {
    int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
    for (int c = 0; c < a.out_cols; ++c)
      dst[c * Z + z] = totals[c * Z + z] < 0.0f;
  }
  if (z == 0) {
    ok_out[cw] = ok;
    it_out[cw] = used;
  }
}

// P codewords per block (P >= 2; see the note at the top of the file).  The
// arithmetic per codeword is the one-codeword kernel's, so the results are
// bit-identical.  Shared memory: P sets of totals, the edge table (message
// offsets scaled by P: a sum-product block's scratch is (E, P*Z)), the row
// offsets and one flag word per codeword.  The min-sum family's block share
// of the scratch is (row, word, P*Z): a row's words are one contiguous run
// per word across the P codewords.
template <bool SUM_PRODUCT, typename MSG>
__global__ void __launch_bounds__(MAX_THREADS, SUM_PRODUCT ? 1 : 2)
ldpc_layered_packed_kernel(const float* __restrict__ llr,
                           int8_t* __restrict__ bits, int* __restrict__ ok_out,
                           int* __restrict__ it_out, void* __restrict__ scratch,
                           const int4* __restrict__ edges_g,
                           const int* __restrict__ row_start_g, DecodeArgs a,
                           int P, int ncw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  int4* edges = reinterpret_cast<int4*>(smem + align16((size_t)P * nc * Z * 4));
  int* row_start = reinterpret_cast<int*>(edges + E);
  int* flags = row_start + nr + 1;

  const int t = threadIdx.x;
  const int k = t / Z;       // codeword of this thread within the block
  const int z = t - k * Z;   // its lane
  const int L = P * Z;       // lanes of the block
  const size_t cw = (size_t)blockIdx.x * P + k;
  const bool active = k < P && cw < (size_t)ncw;
  float* totals = reinterpret_cast<float*>(smem) + (size_t)(active ? k : 0) * nc * Z;

  for (int i = t; i < E; i += blockDim.x) {
    int4 ed = edges_g[i];
    ed.z *= P;
    edges[i] = ed;
  }
  for (int i = t; i <= nr; i += blockDim.x) row_start[i] = row_start_g[i];

  if (active)
    load_totals(totals, llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z), z, a);
  __syncthreads();

  float* c2v = static_cast<float*>(scratch) + (size_t)blockIdx.x * ((size_t)E * L) + t;
  unsigned* words = static_cast<unsigned*>(scratch) +
                    (size_t)blockIdx.x * ((size_t)nr * RowWords<MSG>::N * L) + t;
  RowsAhead<MSG> ahead;
  int used = a.iterations;
  bool passed = false;   // this thread's codeword passed its parity vote
  bool done = !active;   // nothing (more) to do for this thread

  for (int it = 0; it < a.iterations; ++it) {
    const bool first = it == 0;
    const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
    unsigned bad = 0;
    if (t < P) flags[t] = 0;  // read last before the previous sweep's last barrier
    for (int r = 0; r < nr; ++r) {
      const int e0 = row_start[r];
      const int deg = row_start[r + 1] - e0;
      if (!done) {
        if constexpr (SUM_PRODUCT) {
          bad |= layered_sp_row(totals, c2v, edges, e0, deg, z, Z, first);
        } else {
          const RowMsgs old = ahead.next(words, r, nr, L, first);
          bad |= layered_row_compressed<MSG>(
              totals, old, words + (size_t)r * RowWords<MSG>::N * L, L, edges,
              e0, deg, z, Z, first, alpha_t, a.offset_rule, a.beta);
        }
      }
      __syncthreads();
    }
    if (a.early_termination) {  // uniform over the block
      if (!done && (bad & SIGN_BIT)) flags[k] = 1;
      __syncthreads();
      if (!done && !flags[k]) {
        passed = done = true;
        used = it;
      }
      if (__syncthreads_and(done)) break;
    }
  }

  // Codewords that never passed (or a run to budget) get one clean syndrome
  // pass over their settled totals.  (Every earlier read of the flags lies
  // before a barrier: the vote's own, or a row's.)
  if (t < P) flags[t] = 0;
  __syncthreads();
  if (active && !passed) {
    const unsigned bad = syndrome_bits(totals, edges, row_start, nr, z, Z);
    if (bad & SIGN_BIT) flags[k] = 1;
  }
  __syncthreads();

  if (active) {
    int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
    for (int c = 0; c < a.out_cols; ++c)
      dst[c * Z + z] = totals[c * Z + z] < 0.0f;
    if (z == 0) {
      ok_out[cw] = passed || !flags[k];
      it_out[cw] = used;
    }
  }
}

extern "C" int ldpc_layered_max_degree() { return MAX_DEG; }
extern "C" int ldpc_layered_max_z() { return MAX_THREADS; }
extern "C" int ldpc_layered_max_shared_bytes() { return max_shared_bytes_optin(); }

// Dynamic shared memory of one block of P codewords: P sets of totals, edge
// table, row offsets and, for P > 1, a flag word per codeword.
extern "C" int ldpc_layered_shared_bytes(int Z, int nc, int nr, int E, int P) {
  return (int)(align16((size_t)P * nc * Z * 4) + (size_t)E * 16 +
               (size_t)(nr + 1) * 4 + (P > 1 ? (size_t)P * 4 : 0));
}

template <bool SUM_PRODUCT, typename MSG>
static const void* kernel_of(int P, bool offset_rule) {
  if (P > 1) return (const void*)ldpc_layered_packed_kernel<SUM_PRODUCT, MSG>;
  if constexpr (SUM_PRODUCT)
    return (const void*)ldpc_layered_sp_kernel;
  else if (offset_rule)
    return (const void*)ldpc_layered_min_sum_kernel<MSG, true>;
  else
    return (const void*)ldpc_layered_min_sum_kernel<MSG, false>;
}

template <bool SUM_PRODUCT, typename MSG>
static int launch(const void* llr, void* bits, void* ok, void* iters, void* scratch,
                  const void* edges, const void* row_start, int ncw, int P,
                  const DecodeArgs& a, cudaStream_t stream) {
  const int threads = (P * a.Z + 31) / 32 * 32;
  const int smem_bytes = ldpc_layered_shared_bytes(a.Z, a.nc, a.nr, a.E, P);
  cudaError_t err = cudaFuncSetAttribute(kernel_of<SUM_PRODUCT, MSG>(P, a.offset_rule),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const float* in = (const float*)llr;
  const int4* e = (const int4*)edges;
  const int* rs = (const int*)row_start;
  if (P > 1) {
    ldpc_layered_packed_kernel<SUM_PRODUCT, MSG>
        <<<(ncw + P - 1) / P, threads, smem_bytes, stream>>>(
            in, (int8_t*)bits, (int*)ok, (int*)iters, scratch, e, rs, a, P, ncw);
  } else if constexpr (SUM_PRODUCT) {
    ldpc_layered_sp_kernel<<<ncw, threads, smem_bytes, stream>>>(
        in, (int8_t*)bits, (int*)ok, (int*)iters, (float*)scratch, e, rs, a);
  } else if (a.offset_rule) {
    ldpc_layered_min_sum_kernel<MSG, true><<<ncw, threads, smem_bytes, stream>>>(
        in, (int8_t*)bits, (int*)ok, (int*)iters, (unsigned*)scratch, e, rs, a);
  } else {
    ldpc_layered_min_sum_kernel<MSG, false><<<ncw, threads, smem_bytes, stream>>>(
        in, (int8_t*)bits, (int*)ok, (int*)iters, (unsigned*)scratch, e, rs, a);
  }
  return (int)cudaGetLastError();
}

template <bool SUM_PRODUCT, typename MSG>
static int occupancy(int Z, int P, int smem_bytes, bool offset_rule) {
  int n = 0;
  const void* kernel = kernel_of<SUM_PRODUCT, MSG>(P, offset_rule);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, (P * Z + 31) / 32 * 32, smem_bytes);
  return err == cudaSuccess ? n : -(int)err;
}

// Blocks of the instantiation that `ldpc_layered_decode` would launch for these
// arguments that one SM of the current device holds at a time (registers,
// threads and shared memory considered); negative: a CUDA error code.
extern "C" int ldpc_layered_blocks_per_sm(int rule, int bf16_messages,
                                          int codewords_per_block, int Z, int nc,
                                          int nr, int E) {
  const int P = codewords_per_block;
  if (Z < 1 || P < 1 || P * Z > MAX_THREADS) return -(int)cudaErrorInvalidValue;
  const int smem_bytes = ldpc_layered_shared_bytes(Z, nc, nr, E, P);
  const bool offset = rule == RULE_OFFSET_MIN_SUM;
  if (rule == RULE_SUM_PRODUCT) return occupancy<true, float>(Z, P, smem_bytes, offset);
  if (bf16_messages) return occupancy<false, __nv_bfloat16>(Z, P, smem_bytes, offset);
  return occupancy<false, float>(Z, P, smem_bytes, offset);
}

// Bytes of one block's share of the scratch: sum-product, P*E*Z float
// messages, laid out (E, P*Z); the min-sum family, nr*N*P*Z words of 32 bits,
// laid out (row, word, P*Z) (N = 3 with float32 messages, 2 with bfloat16).
extern "C" int ldpc_layered_scratch_bytes(int rule, int bf16_messages, int Z,
                                          int nr, int E, int P) {
  if (rule == RULE_SUM_PRODUCT) return E * P * Z * 4;
  return nr * (bf16_messages ? RowWords<__nv_bfloat16>::N : RowWords<float>::N) * P * Z * 4;
}

// Launches the decoder for `ncw` codewords on `stream`.  `rule` is 0
// (min-sum), 1 (offset-min-sum) or 2 (sum-product); `bf16_messages` selects
// the message type (min-sum family only).  `codewords_per_block` P = 1 runs
// one block per codeword, P > 1 runs ceil(ncw / P) blocks of the packed
// kernel.  `scratch` holds ceil(ncw / P) blocks' shares of
// ldpc_layered_scratch_bytes each.  Does not synchronise and allocates
// nothing.  Returns cudaGetLastError().
extern "C" int ldpc_layered_decode(
    const void* llr, void* bits, void* ok, void* iters, void* scratch,
    const void* edges, const void* row_start, int ncw, int Z, int nc, int nr,
    int E, int out_cols, int d_input, int fill_lo, int fill_hi, int iterations,
    int early_termination, int rule, int bf16_messages,
    int codewords_per_block, float alpha, float beta, float alpha0, int n0,
    void* stream) {
  const int P = codewords_per_block;
  if (Z < 1 || Z > MAX_THREADS || ncw < 1) return (int)cudaErrorInvalidValue;
  if (P < 1 || P * Z > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (rule < RULE_MIN_SUM || rule > RULE_SUM_PRODUCT) return (int)cudaErrorInvalidValue;
  if (rule == RULE_SUM_PRODUCT && bf16_messages) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.Z = Z; a.nc = nc; a.nr = nr; a.E = E; a.out_cols = out_cols;
  a.d_input = d_input; a.fill_lo = fill_lo; a.fill_hi = fill_hi;
  a.iterations = iterations; a.early_termination = early_termination;
  a.offset_rule = rule == RULE_OFFSET_MIN_SUM;
  a.alpha = alpha; a.beta = beta; a.alpha0 = alpha0; a.n0 = n0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rule == RULE_SUM_PRODUCT)
    return launch<true, float>(llr, bits, ok, iters, scratch, edges, row_start, ncw, P, a, s);
  if (bf16_messages)
    return launch<false, __nv_bfloat16>(llr, bits, ok, iters, scratch, edges, row_start, ncw, P, a, s);
  return launch<false, float>(llr, bits, ok, iters, scratch, edges, row_start, ncw, P, a, s);
}
