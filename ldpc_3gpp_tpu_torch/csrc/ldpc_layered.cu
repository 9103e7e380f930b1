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
// Several small-Z codewords per block replace the TPU kernel's packed tiles
// (decoder_pallas.py::_auto_pack, the segment-local parity vote and the
// pack/unpack transposes of its wrapper), in two kernels of their own, so
// that the one-codeword kernels keep their registers.  What bounds a small-Z
// block on this card: one block per codeword is one warp with Z live lanes
// (20 of 32 at Z=20), a private copy of the edge table per block, and at most
// 32 resident blocks per SM.  The min-sum family at Z <= 32 takes the warp
// form (ldpc_layered_warp_kernel, below the packed kernel: each warp owns 32
// / Z codewords, or one, and no warp waits for another).  Sum-product, Z > 32
// and a P whose warps would not fit a block take ldpc_layered_packed_kernel:
// thread t owns lane t % Z of codeword t / Z, one edge table serves all P,
// and the block's share of the scratch is laid out (row, word, P*Z)
// (sum-product: (E, P*Z)) so that a row's words are one contiguous run across
// the P codewords.  Its votes and stops are per codeword (a flag word each in
// shared memory, set between two barriers); a codeword that passed stops at
// the sweep the one-codeword kernel stops at and writes nothing afterwards,
// its lanes still reach every barrier, and the block leaves when all P are
// done.

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

// ---- P codewords per block at Z <= 32: the warp form ---------------------
//
// ldpc_layered_warp_kernel replaces ldpc_layered_packed_kernel for the min-sum
// family at Z <= 32 (the packed kernel keeps sum-product and Z > 32).  Taken
// apart on an NVIDIA H100 80GB HBM3 at 700 W at config #1's code (BG2 Z=20;
// tools/layered_probe.py's `packed_block` family, PERF.md section 6), the
// packed kernel was bound by the instructions of its row (the one-codeword
// kernel's row alone took a fifth off) and by its
// words' traffic (a quarter); its block-wide barriers and its stragglers cost
// little, and its words on chip lost because they cut the blocks per SM.  At
// 2,048 codewords an SM holds about 16 codewords in all, and a lone warp's row
// step takes about 550 cycles (BG2 Z=8, four codewords a warp, one warp a
// scheduler), so a launch is only as fast as the codewords its SMs hold at
// once, and a second round of a few codewords doubles its time.
// Here a warp owns its codewords outright: G = min(P, 32 / Z) of them, lanes
// k*Z .. k*Z + Z - 1 for codeword k; a block is ceil(P / G) such warps, at
// most what a block holds (block_codewords: one block per SM at Z=20, 16
// codewords), that share one edge table and never wait for each other.  The warps are
// persistent: the grid is what the SMs hold, and each warp takes its next
// codewords from a counter in global memory (atomicAdd; the order changes no
// result) until none are left, so no SM idles behind a straggler.  A warp's
// totals are laid out (column, G*Z) in shared memory, so that the G codewords
// of a row read one run of lanes, and its words (row, word, G*Z) beside them:
// no word goes through the L2, and each lane zeroes its own words when it
// takes a codeword, so that sweep 0 reads zero messages.  Rows are separated
// by __syncwarp(), a codeword votes by __ballot_sync over its lanes, and a
// warp takes new codewords when all of its own are done.  The row is the
// one-codeword min-sum kernel's (min_sum_row_slots: byte offsets and wrap
// lanes in the edge records, unrolled to its degree, the rule a template
// parameter), found by one (first edge, degree) record per row that is read,
// with the row's words, a row ahead.

constexpr unsigned FULL_WARP = 0xffffffffu;
// the most shared memory one block of an H100 may opt in to
constexpr size_t WARP_FORM_SHARED_LIMIT = 232448;
#define WARP_FORM_MAX_THREADS 512

// Codewords that one warp holds, warps of a block of P codewords.
__host__ __device__ inline int warp_codewords(int Z, int P) { return P < 32 / Z ? P : 32 / Z; }
__host__ __device__ inline int warp_count(int Z, int P) {
  const int G = warp_codewords(Z, P);
  return (P + G - 1) / G;
}
// Bytes of a warp-form block's edge table and row records, and of one warp's
// state: its totals and its words (`words` 32-bit words per row and lane).
__host__ __device__ inline size_t warp_table_bytes(int nr, int E) {
  return align16((size_t)E * 16 + (size_t)nr * 8);
}
__host__ __device__ inline size_t warp_state_bytes(int Z, int nc, int nr, int words, int P) {
  const size_t L = (size_t)warp_codewords(Z, P) * Z;
  return align16((size_t)nc * L * 4) + (size_t)nr * words * L * 4;
}
static size_t warp_shared_bytes(int Z, int nc, int nr, int E, int P, int words) {
  return warp_table_bytes(nr, E) + (size_t)warp_count(Z, P) * warp_state_bytes(Z, nc, nr, words, P);
}
// The warp form: the min-sum family, P > 1 codewords at Z <= 32.
static bool warp_form(int rule, int Z, int P) {
  return rule != RULE_SUM_PRODUCT && P > 1 && Z <= 32;
}
// The most warps of G codewords that one warp-form block holds: its threads,
// MAX_THREADS live lanes and the shared memory of the warps' state.
static int warp_max_warps(int Z, int nc, int nr, int E, int G, int words) {
  const size_t room = (WARP_FORM_SHARED_LIMIT - warp_table_bytes(nr, E)) /
                      warp_state_bytes(Z, nc, nr, words, G);
  return min(min(WARP_FORM_MAX_THREADS / 32, MAX_THREADS / (G * Z)), (int)room);
}
// The codewords that one block holds for P asked for: in the warp form at
// most what its warps hold (its warps are persistent, so P only sets how many
// share a block), else P.
static int block_codewords(int rule, int bf16_messages, int Z, int nc, int nr, int E, int P) {
  if (!warp_form(rule, Z, P)) return P;
  const int G = warp_codewords(Z, P);
  const int N = bf16_messages ? RowWords<__nv_bfloat16>::N : RowWords<float>::N;
  return min(P, G * warp_max_warps(Z, nc, nr, E, G, N));
}

// Lane z of every column of one codeword's totals from its channel LLRs into
// t (the codeword's lane z of column 0), the columns L lanes apart
// (load_totals with a stride).
__device__ __forceinline__ void load_totals_lanes(float* t, const float* src, int z, int L,
                                                  const DecodeArgs& a) {
  const int Z = a.Z, nc = a.nc;
  if (a.d_input) {
    t[0] = 0.0f;
    t[L] = 0.0f;
    for (int c = 2; c < nc; ++c) {
      const int j = (c - 2) * Z + z;
      t[c * L] = (j >= a.fill_lo && j < a.fill_hi) ? FILLER_LLR : src[j];
    }
  } else {
    for (int c = 0; c < nc; ++c) t[c * L] = src[c * Z + z];
  }
}

// syndrome_bits through the warp form's byte offsets and row records.
__device__ __forceinline__ unsigned warp_syndrome_bits(const unsigned char* totals,
                                                       const int4* edges, const int2* rows,
                                                       int nr, int z, int z4, int Z4) {
  unsigned bad = 0;
  for (int r = 0; r < nr; ++r) {
    const int2 row = rows[r];
    unsigned par = 0;
    for (int e = row.x; e < row.x + row.y; ++e) {
      const int4 ed = edges[e];
      par ^= *reinterpret_cast<const unsigned*>(totals + ed.z + z4 - (z >= ed.w ? Z4 : 0));
    }
    bad |= par;
  }
  return bad;
}

// min_sum_row for the warp form: the same bodies, reached by a chain of
// tests on the degree, the most frequent of both base graphs first, in
// place of a jump table.  On an NVIDIA H100 80GB HBM3 at 700 W, at BG2 Z=20
// and Z=8, the chain took 5-14 % off the warp kernel (tools/layered_probe.py
// `packed`, PERF.md section 6):
// at a few warps per scheduler a row waits on the table's load and the
// indirect branch.
template <typename MSG, bool OFFSET>
__device__ __forceinline__ unsigned warp_row(unsigned char* totals, const int4* ms, int deg,
                                             const RowMsgs& old, unsigned* w, int L, int z,
                                             int z4, int Z4, float alpha_t, float beta) {
#define WARP_ROW_EXACT(D)                                                                    \
  if (deg == D)                                                                              \
    return min_sum_row_slots<MSG, D, OFFSET>(totals, ms, D, old, w, L, z, z4, Z4, alpha_t, \
                                             beta);
  WARP_ROW_EXACT(4) WARP_ROW_EXACT(5) WARP_ROW_EXACT(6) WARP_ROW_EXACT(3) WARP_ROW_EXACT(7)
  WARP_ROW_EXACT(8) WARP_ROW_EXACT(10) WARP_ROW_EXACT(9) WARP_ROW_EXACT(19)
#undef WARP_ROW_EXACT
  return min_sum_row_slots<MSG, MAX_DEG, OFFSET>(totals, ms, deg, old, w, L, z, z4, Z4, alpha_t,
                                                 beta);
}

// P codewords per block of ceil(P / G) persistent warps (see above); warp w
// takes G codewords at a time (its share of the P, the last warp fewer where
// P is not a multiple of G) from `next`, which the launch sets to 0.  The
// edge table in shared memory keeps the plan's (.x, .y) and gives .z the
// byte offset in a warp's totals of the edge's column at lane `shift` of its
// codeword 0 (4 * (col*G*Z + shift)) and .w the first lane that wraps (Z -
// shift), so that lane z of codeword k is at .z + 4(kZ + z) - (z >= .w ? 4Z :
// 0).
template <typename MSG, bool OFFSET>
__global__ void __launch_bounds__(WARP_FORM_MAX_THREADS, 1)
ldpc_layered_warp_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                         int* __restrict__ ok_out, int* __restrict__ it_out,
                         int* __restrict__ next, const int4* __restrict__ edges_g,
                         const int* __restrict__ row_start_g, DecodeArgs a, int P, int ncw) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = RowWords<MSG>::N;
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  const int G = warp_codewords(Z, P);
  const int L = G * Z;  // lanes of a warp's state
  int4* edges = reinterpret_cast<int4*>(smem);
  int2* rows = reinterpret_cast<int2*>(edges + E);  // (first edge, degree)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = lane / Z;                      // codeword of this lane within its warp
  const int z = lane - k * Z;                  // its check
  const int taken = min(G, P - warp * G);      // codewords this warp takes at a time
  unsigned char* totals = smem + warp_table_bytes(nr, E) +
                          (size_t)warp * warp_state_bytes(Z, nc, nr, N, P);
  // this lane's words (lanes past the warp's codewords read lane 0's, and
  // store none)
  unsigned* words = reinterpret_cast<unsigned*>(totals + align16((size_t)nc * L * 4)) +
                    (k < G ? k * Z + z : 0);
  const int row_words = N * L;
  const int z4 = 4 * (k * Z + z), Z4 = 4 * Z;
  // this codeword's lanes in the warp's votes
  const unsigned mine = k < G ? (Z == 32 ? FULL_WARP : (1u << Z) - 1u) << (k * Z) : 0u;

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    int4 ed = edges_g[i];
    ed.z = 4 * (ed.x * G + ed.y);
    ed.w = Z - ed.y;
    edges[i] = ed;
  }
  for (int i = threadIdx.x; i < nr; i += blockDim.x)
    rows[i] = make_int2(row_start_g[i], row_start_g[i + 1] - row_start_g[i]);
  __syncthreads();  // the block's only barrier: from here on each warp goes alone

  for (;;) {
    int first_cw = 0;
    if (lane == 0) first_cw = atomicAdd(next, taken);
    first_cw = __shfl_sync(FULL_WARP, first_cw, 0);
    if (first_cw >= ncw) break;  // uniform over the warp
    const size_t cw = (size_t)first_cw + k;
    const bool active = k < taken && cw < (size_t)ncw;
    if (active) {
      load_totals_lanes(reinterpret_cast<float*>(totals) + k * Z + z,
                        llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z), z, L, a);
      for (int i = 0; i < nr * N; ++i) words[i * L] = 0u;
    }
    __syncwarp();

    int used = a.iterations;
    bool passed = false;   // this lane's codeword passed its parity vote
    bool done = !active;   // nothing (more) to do for this lane
    // The next row's record and this lane's words of it are read a row ahead
    // (no row writes another's words), so that a row starts with its totals.
    int2 row = rows[0];
    RowMsgs old = load_row_msgs<MSG>(words, L);
    for (int it = 0; it < a.iterations; ++it) {
      float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
      asm("" : "+f"(alpha_t));  // in a register across rows
      unsigned bad = 0;
      for (int r = 0, w = 0; r < nr; ++r, w += row_words) {
        const int2 cur = row;
        const RowMsgs cur_old = old;
        const int wn = r + 1 < nr ? w + row_words : 0;  // past the last row: row 0
        row = rows[r + 1 < nr ? r + 1 : 0];
        old = load_row_msgs<MSG>(words + wn, L);
        // parity of the totals as read in this sweep
        if (!done)
          bad |= warp_row<MSG, OFFSET>(totals, edges + cur.x, cur.y, cur_old, words + w, L, z,
                                       z4, Z4, alpha_t, a.beta);
        __syncwarp();
      }
      if (a.early_termination) {
        const unsigned odd = __ballot_sync(FULL_WARP, !done && (bad & SIGN_BIT));
        if (!done && !(odd & mine)) {
          passed = done = true;
          used = it;
        }
        if (__all_sync(FULL_WARP, done)) break;
      }
    }

    // A codeword that never passed (or a run to budget) gets one clean
    // syndrome pass over the settled totals.
    unsigned bad = 0;
    if (active && !passed) bad = warp_syndrome_bits(totals, edges, rows, nr, z, z4, Z4);
    const unsigned odd = __ballot_sync(FULL_WARP, bad & SIGN_BIT);
    if (active) {
      const float* t = reinterpret_cast<const float*>(totals) + k * Z + z;
      int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
      for (int c = 0; c < a.out_cols; ++c) dst[c * Z + z] = t[c * L] < 0.0f;
      if (z == 0) {
        ok_out[cw] = passed || !(odd & mine);
        it_out[cw] = used;
      }
    }
    __syncwarp();  // every lane's reads of this state before the next codeword's loads
  }
}

extern "C" int ldpc_layered_max_degree() { return MAX_DEG; }
extern "C" int ldpc_layered_max_z() { return MAX_THREADS; }
extern "C" int ldpc_layered_max_shared_bytes() { return max_shared_bytes_optin(); }

// Threads of a block of P codewords (block_codewords): the warp form's whole
// warps, else P*Z lanes rounded up to whole warps.
static int block_threads(int rule, int Z, int P) {
  return warp_form(rule, Z, P) ? warp_count(Z, P) * 32 : (P * Z + 31) / 32 * 32;
}

// Dynamic shared memory of one block for P codewords asked for
// (block_codewords).  The warp form: the edge table and row records, then each
// warp's totals and words.  Else P sets of totals, edge table, row offsets
// and, for P > 1, a flag word per codeword.
extern "C" int ldpc_layered_shared_bytes(int rule, int bf16_messages, int Z, int nc, int nr,
                                         int E, int P) {
  P = block_codewords(rule, bf16_messages, Z, nc, nr, E, P);
  if (warp_form(rule, Z, P))
    return (int)warp_shared_bytes(Z, nc, nr, E, P, bf16_messages ? RowWords<__nv_bfloat16>::N
                                                                   : RowWords<float>::N);
  return (int)(align16((size_t)P * nc * Z * 4) + (size_t)E * 16 +
               (size_t)(nr + 1) * 4 + (P > 1 ? (size_t)P * 4 : 0));
}

template <bool SUM_PRODUCT, typename MSG>
static const void* kernel_of(int Z, int P, bool offset_rule) {
  if (warp_form(SUM_PRODUCT ? RULE_SUM_PRODUCT : RULE_MIN_SUM, Z, P))
    return offset_rule ? (const void*)ldpc_layered_warp_kernel<MSG, true>
                       : (const void*)ldpc_layered_warp_kernel<MSG, false>;
  if (P > 1) return (const void*)ldpc_layered_packed_kernel<SUM_PRODUCT, MSG>;
  if constexpr (SUM_PRODUCT)
    return (const void*)ldpc_layered_sp_kernel;
  else if (offset_rule)
    return (const void*)ldpc_layered_min_sum_kernel<MSG, true>;
  else
    return (const void*)ldpc_layered_min_sum_kernel<MSG, false>;
}

// The warp form's grid: as many blocks as the SMs hold at once (the
// occupancy API), at most one per P codewords.
static int warp_form_blocks(const void* kernel, int threads, int smem_bytes, int ncw, int P) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  return min((ncw + P - 1) / P, max(1, sms * per_sm));
}

template <bool SUM_PRODUCT, typename MSG>
static int launch(const void* llr, void* bits, void* ok, void* iters, void* scratch,
                  const void* edges, const void* row_start, int ncw, int P,
                  const DecodeArgs& a, cudaStream_t stream) {
  const int rule = SUM_PRODUCT ? RULE_SUM_PRODUCT : a.offset_rule;
  const int bf16 = sizeof(MSG) == 2;
  const int threads = block_threads(rule, a.Z, P);
  const int smem_bytes = ldpc_layered_shared_bytes(rule, bf16, a.Z, a.nc, a.nr, a.E, P);
  const void* kernel = kernel_of<SUM_PRODUCT, MSG>(a.Z, P, a.offset_rule);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const float* in = (const float*)llr;
  const int4* e = (const int4*)edges;
  const int* rs = (const int*)row_start;
  if (warp_form(rule, a.Z, P)) {
    const int blocks = warp_form_blocks(kernel, threads, smem_bytes, ncw, P);
    if (blocks < 0) return -blocks;
    err = cudaMemsetAsync(scratch, 0, sizeof(int), stream);  // the codeword counter
    if (err != cudaSuccess) return (int)err;
    if (a.offset_rule)
      ldpc_layered_warp_kernel<MSG, true><<<blocks, threads, smem_bytes, stream>>>(
          in, (int8_t*)bits, (int*)ok, (int*)iters, (int*)scratch, e, rs, a, P, ncw);
    else
      ldpc_layered_warp_kernel<MSG, false><<<blocks, threads, smem_bytes, stream>>>(
          in, (int8_t*)bits, (int*)ok, (int*)iters, (int*)scratch, e, rs, a, P, ncw);
  } else if (P > 1) {
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
static int occupancy(int rule, int Z, int nc, int nr, int E, int P) {
  int n = 0;
  const int bf16 = sizeof(MSG) == 2;
  const int smem_bytes = ldpc_layered_shared_bytes(rule, bf16, Z, nc, nr, E, P);
  const void* kernel = kernel_of<SUM_PRODUCT, MSG>(Z, P, rule == RULE_OFFSET_MIN_SUM);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, block_threads(rule, Z, P), smem_bytes);
  return err == cudaSuccess ? n : -(int)err;
}

// Blocks of the instantiation that `ldpc_layered_decode` would launch for these
// arguments that one SM of the current device holds at a time (registers,
// threads and shared memory considered); negative: a CUDA error code.
extern "C" int ldpc_layered_blocks_per_sm(int rule, int bf16_messages,
                                          int codewords_per_block, int Z, int nc,
                                          int nr, int E) {
  int P = codewords_per_block;
  if (Z < 1 || P < 1 || P * Z > MAX_THREADS) return -(int)cudaErrorInvalidValue;
  P = block_codewords(rule, bf16_messages, Z, nc, nr, E, P);
  if (rule == RULE_SUM_PRODUCT) return occupancy<true, float>(rule, Z, nc, nr, E, P);
  if (bf16_messages) return occupancy<false, __nv_bfloat16>(rule, Z, nc, nr, E, P);
  return occupancy<false, float>(rule, Z, nc, nr, E, P);
}

// Bytes of one block's share of the scratch: sum-product, P*E*Z float
// messages, laid out (E, P*Z); the min-sum family, nr*N*P*Z words of 32 bits,
// laid out (row, word, P*Z) (N = 3 with float32 messages, 2 with bfloat16);
// the warp form none: its scratch is one int per launch, the codeword counter.
extern "C" int ldpc_layered_scratch_bytes(int rule, int bf16_messages, int Z, int nc,
                                          int nr, int E, int P) {
  if (rule == RULE_SUM_PRODUCT) return E * P * Z * 4;
  if (warp_form(rule, Z, P)) return 0;
  const int N = bf16_messages ? RowWords<__nv_bfloat16>::N : RowWords<float>::N;
  return nr * N * P * Z * 4;
}

// Launches the decoder for `ncw` codewords on `stream`.  `rule` is 0
// (min-sum), 1 (offset-min-sum) or 2 (sum-product); `bf16_messages` selects
// the message type (min-sum family only).  `codewords_per_block` P = 1 runs
// one block per codeword, P > 1 runs ceil(ncw / P) blocks of the packed
// kernel, or (the warp form) as many blocks of the warp kernel as the SMs
// hold, at most ceil(ncw / P), each of at most P codewords (block_codewords).
// `scratch` holds ceil(ncw / P) blocks' shares
// of ldpc_layered_scratch_bytes each, or (the warp form) one int, which the
// launch sets to 0 on `stream`.  Does not synchronise and allocates nothing.
// Returns cudaGetLastError().
extern "C" int ldpc_layered_decode(
    const void* llr, void* bits, void* ok, void* iters, void* scratch,
    const void* edges, const void* row_start, int ncw, int Z, int nc, int nr,
    int E, int out_cols, int d_input, int fill_lo, int fill_hi, int iterations,
    int early_termination, int rule, int bf16_messages,
    int codewords_per_block, float alpha, float beta, float alpha0, int n0,
    void* stream) {
  int P = codewords_per_block;
  if (Z < 1 || Z > MAX_THREADS || ncw < 1) return (int)cudaErrorInvalidValue;
  if (rule < RULE_MIN_SUM || rule > RULE_SUM_PRODUCT) return (int)cudaErrorInvalidValue;
  if (P < 1 || P * Z > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (rule == RULE_SUM_PRODUCT && bf16_messages) return (int)cudaErrorInvalidValue;
  P = block_codewords(rule, bf16_messages, Z, nc, nr, E, P);
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
